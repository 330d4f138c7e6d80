"""What the PyTorch port's serving, bench and profiling tools share
(tools/bench_multistream_torch.py, tools/bench_scaling_torch.py,
tools/bench_latency_torch.py, bench_torch.py, tools/bench_matrix_torch.py,
tools/profile_*_torch.py): the filter served at a frame size, the rows
they print and append, the card's name and power limit, host frames, and
the process's resident memory.  Imports `torch` and the port only.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BUDGET_FPS = 480.0  # 8 x 1080p60 aggregate (BASELINE.md:31-32)
EFFICIENCY_TARGET = 0.8  # stream scaling (BASELINE.md:27)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_size(text: str) -> tuple[int, int]:
    h, w = map(int, text.lower().split("x"))
    return h, w


def serving_filter(size: tuple[int, int]):
    """`flagship_filter()` from 540 rows up; below, the flagship cut to the
    dry run's tiny tracker (48x64 detection, a 4x4 grid, a 2-frame window),
    as the JAX tools cut theirs for small CPU sizes."""
    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.parallel import dryrun

    return lt.flagship_filter() if size[0] >= 540 else dryrun.tiny_flagship()


def check_json_out(json_out: str | None) -> str | None:
    """`json_out`, refused (ValueError) when it names one of the JAX
    package's BENCH_* records."""
    if json_out and os.path.basename(json_out).startswith("BENCH_"):
        raise ValueError(f"{json_out}: the BENCH_* files are the JAX package's records")
    return json_out


def append(row: dict, json_out: str | None) -> None:
    """Append one measurement as a JSON line to `json_out` (nothing when it
    is None; `check_json_out`)."""
    if check_json_out(json_out):
        with open(json_out, "a") as fh:
            fh.write(json.dumps(row) + "\n")


def emit(row: dict, json_out: str | None = None) -> dict:
    """Print one measurement as a JSON line on stdout, and `append` it to
    `json_out`."""
    print(json.dumps(row), flush=True)
    append(row, json_out)
    return row


def card_line(device) -> str:
    """What ran the measurement: on a card its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (that of the device's index), else "cpu"."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[dev.index or 0]


def random_ring(size: tuple[int, int], n: int = 4) -> list:
    """n host u8 HWC BGR frames of uniform noise (the JAX tools' ring)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(*size, 3), dtype=np.uint8) for _ in range(n)]


def rss_mb() -> float:
    """The process's resident set, MB."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6
