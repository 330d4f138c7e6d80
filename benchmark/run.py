"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of `BENCHMARK.json`)
names a configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json), whose `driver` (drivers/<driver>.py) sets the
cell up, measures for `--seconds`, and judges what the timed path
delivered against the plain reference (reference/) by the limits in
limits/<cell>.json.  `--trace 1` also profiles a short slice after the
window and reports the cell's per-layer metrics (metrics/<name>.py) in
place of its end-to-end ones.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number with its limit (also the last
lines of standard error).  Without a CUDA device, with fewer devices than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with another code than 0."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

from harness.runctx import process_start

STARTED = process_start()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Modules whose presence after the window refuses the run, compared by the
# top-level name (the part before the first dot), whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "livevisionkit_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernel library is built into build/torch_kernels/), and no
    library left free to load JAX."""
    cache = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Drive `cell` once on `device` and return the result line (without
    looking for a chip: the caller does)."""
    import torch

    from harness.runctx import Run
    from harness.trace import breakdown

    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
              started=STARTED)
    importlib.import_module(f"drivers.{cell.traffic['driver']}").run(run)
    values = run.layers if trace else run.end_to_end
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        if m["name"] in values:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"{cell.name}: the driver did not measure {m['name']}")
    dev = run.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak,
    }
    result = {
        "correct": run.correct(),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.slice is not None:
        device_info["busy_s"] = run.slice.busy_us() * 1e-6
        device_info["window_s"] = run.slice.window_us * 1e-6
        result["breakdown"] = breakdown(run.slice)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim, _) in run.checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    sys.path.insert(1, str(ROOT))  # the program, from the checkout's root

    from harness import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    loaded = forbidden_modules()
    if loaded:
        print(f"refused: modules of JAX or the JAX package are loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
