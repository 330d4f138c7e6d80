"""Headline benchmark of the PyTorch port: the flagship stabilizer's 1080p
ms per frame on one card (the counterpart of bench.py).

Prints ONE JSON line with bench.py's keys: {"metric", "value", "unit",
"vs_baseline"}, vs_baseline = 8.0 / ms against the 8 ms/frame target
(BASELINE.md:26; > 1 is better than the target).  The card's name and
power limit go to stderr on an earlier line.

`flagship_filter()` steps over bench.py's ring of 8 1080p YUV frames of
rolled noise on the card, the frame of step t taken from the ring by the
device's own step counter, as one CUDA graph of the step replayed
(tools/profile_stages_torch.graph_time: CUDA events over back-to-back
replays from an idle card, the least of 3 runs of 60).  On the CPU
(--device cpu, with a small --size for tests) the step is called as it
is and timed by the host clock.

Usage:
    python bench_torch.py [--device cuda|cpu] [--size 1080x1920] [--n 60] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))

from profile_stages_torch import graph_time  # noqa: E402
from serving_torch import card_line, log, parse_size, serving_filter  # noqa: E402

TARGET_MS = 8.0  # BASELINE.md:26
N_RING = 8


def ring(size: tuple[int, int], device="cuda"):
    """bench.py's ring: N_RING (3, H, W) f32 YUV frames, one plane of noise
    rolled by a random walk and repeated over the three planes."""
    import numpy as np
    import torch

    h, w = size
    rng = np.random.default_rng(0)
    base = rng.uniform(0.1, 0.9, size=(1, h, w)).astype(np.float32)
    drift = np.cumsum(rng.uniform(-2, 2, size=(N_RING, 2)), axis=0).astype(int)
    frames = np.stack([np.broadcast_to(np.roll(np.roll(base, d[0], axis=-2), d[1], axis=-1),
                                       (3, h, w)) for d in drift])
    return torch.from_numpy(frames).to(device)


def body_and_state(filt, size: tuple[int, int], device="cuda"):
    """The benchmark's step body over the ring and its initial state."""
    import torch

    import livevisionkit_tpu_torch as lt

    fmt = lt.PixelFormat.YUV
    frames = ring(size, device)
    live = torch.ones((), dtype=torch.bool, device=device)

    def body(st, t):
        idx = (t.to(torch.int64) % N_RING).reshape(1)
        fr = lt.Frame(pixels=frames.index_select(0, idx)[0], timestamp=t / 60.0, valid=live,
                      format=fmt)
        return filt.step(st, fr)

    return body, filt.init(lt.FrameSpec(*size, 3, fmt), device=device)


def bench(size: tuple[int, int] = (1080, 1920), device="cuda", n: int = 60,
          reps: int = 3) -> dict:
    """The benchmark's JSON line."""
    body, state = body_and_state(serving_filter(size), size, device)
    ms = graph_time(body, state, n, reps)
    return {"metric": "1080p_stabilization_latency", "value": ms, "unit": "ms/frame/chip",
            "vs_baseline": TARGET_MS / ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    args = ap.parse_args(argv)

    size = parse_size(args.size)
    log(f"bench_torch on {card_line(args.device)}, {size[0]}x{size[1]}")
    line = bench(size, args.device, args.n, args.reps)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
