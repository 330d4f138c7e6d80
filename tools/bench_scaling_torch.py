"""Stream scaling of the PyTorch port: frames/s against the number of
concurrent streams (the counterpart of tools/bench_scaling.py).

BASELINE.md:27 asks for >= 80% frames/s scaling efficiency.  For each S of
--streams, `MultiStreamFilter(filt, S)` steps a 1080p tick of S streams
as one batched step, replayed as one CUDA graph (`jit_step`), timed with
CUDA events over --ticks replays after its capture (on the CPU: the plain
step, timed by the host clock).  Efficiency(S) = t(1) * S / t(S): the
S-stream tick's throughput against running the S streams one after
another; 1.0 means batching is free.

  * --control swaps in a trivially parallel per-stream workload (a 5x5
    box blur and a pointwise chain, four times, the JAX tool's), the
    harness's own scaling floor, on one device (not with --mesh).
  * --mesh puts one stream on each device of a `parallel/streams` mesh of
    the visible cards (round robin when S exceeds them; on one card
    `cuda:0` repeated, whose rows form one group: the meshless tick), so
    the work a device does is constant and Efficiency(S) = t(1) / t(S).

`scaling` is the function chip_smoke.py calls in-process; it yields each
row as it is measured.  Rows go to stdout as JSON lines, progress to
stderr.

Usage:
    python tools/bench_scaling_torch.py [--device cuda|cpu] [--streams 1,2,4,8]
        [--size 1080x1920] [--ticks 30] [--control] [--mesh] [--base-ms MS]
        [--json-out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from serving_torch import EFFICIENCY_TARGET, emit, log, parse_size, serving_filter  # noqa: E402


def _control(x):
    """Per-stream work with no coupling between streams and nothing
    data-dependent: a 5x5 box blur, separable, and a pointwise chain, four
    times (the JAX tool's control)."""
    import torch.nn.functional as F

    for _ in range(4):
        xp = F.pad(x, (0, 0, 2, 2), mode="replicate")
        x = sum(xp[..., i:i + x.shape[-2], :] for i in range(5)) / 5.0
        xp = F.pad(x, (2, 2, 0, 0), mode="replicate")
        x = sum(xp[..., i:i + x.shape[-1]] for i in range(5)) / 5.0
        x = x.tanh() + 0.1 * x * x
    return x


def _mesh_devices(device, n: int) -> list:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return [dev] * n
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def _time_ticks(step, state, inputs, device, ticks: int) -> float:
    """ms a tick of `ticks` calls of step(state, *inputs[t]) after one call
    (the capture): CUDA events on the card, the host clock on the CPU."""
    import torch

    state, _ = step(state, *inputs[0])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for t in range(ticks):
        state, _ = step(state, *inputs[t % len(inputs)])
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ticks
    return (time.perf_counter() - t0) * 1e3 / ticks


def scaling(filt, streams: list, size: tuple[int, int], device="cuda", ticks: int = 30,
            control: bool = False, mesh: bool = False, base_ms: float | None = None):
    """One row per S of `streams` (module docstring), yielded in order."""
    import numpy as np
    import torch

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter, make_mesh
    from livevisionkit_tpu_torch.utils.compiled import jit_step

    h, w = size
    pix = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 0.9, size=(3, h, w)).astype(np.float32))
    spec = lt.FrameSpec(h, w, 3, lt.PixelFormat.YUV)
    if control and mesh:
        raise ValueError("the control workload runs on one device")
    mode = ("mesh" if mesh else "vmap_1card") + ("_control" if control else "")
    for s in streams:
        batch = torch.stack([pix * (1.0 + 0.01 * i) for i in range(s)]).to(device)
        if control:
            def tick(state, x):
                out = _control(x)
                return state + 1e-9, out[..., ::128, ::128].sum()

            step, state = jit_step(tick), torch.zeros(s, device=device)
            inputs = [(batch,)]
        else:
            grid = make_mesh(s, 1, devices=_mesh_devices(device, s)) if mesh else None
            multi = MultiStreamFilter(filt, s, grid, tile_frames=False)
            step, state = multi.jit_step(), multi.init(spec, device=device)
            live = torch.ones(s, dtype=torch.bool, device=device)
            inputs = [(lt.Frame(pixels=batch, timestamp=torch.full((s,), t / 60.0, device=device),
                                valid=live, format=lt.PixelFormat.YUV),) for t in range(ticks)]
        log(f"S={s}: capture + {ticks} ticks ({mode}, {h}x{w}) ...")
        ms = _time_ticks(step, state, inputs, device, ticks)
        base_ms = ms if base_ms is None else base_ms
        eff = base_ms / ms if mesh else base_ms * s / ms
        yield {"mode": mode, "device": str(device), "streams": s, "size": f"{h}x{w}",
               "warp_filter": None if control else filt.settings.warp_filter,
               "ms_per_step": ms, "ms_per_stream_frame": ms / s, "frames_per_s": 1e3 * s / ms,
               "scaling_efficiency": eff, "target": EFFICIENCY_TARGET,
               "met": eff >= EFFICIENCY_TARGET}
        del step, state, inputs, batch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", default="1,2,4,8")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--ticks", type=int, default=30)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--control", action="store_true")
    which.add_argument("--mesh", action="store_true")
    ap.add_argument("--base-ms", type=float, default=None,
                    help="t(S=1) ms for the efficiency column when S=1 is not run")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args()

    size = parse_size(args.size)
    for row in scaling(serving_filter(size), [int(s) for s in args.streams.split(",")], size,
                       args.device, args.ticks, args.control, args.mesh, args.base_ms):
        emit(row, args.json_out)


if __name__ == "__main__":
    main()
