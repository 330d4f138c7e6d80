"""Stage-level latency profile of the PyTorch port's stabilization step
(the counterpart of tools/profile_stages.py), and `graph_time`, the timer
the port's bench and profiling tools share.

`graph_time(body, state)` times `body(state, t) -> (state, out)` compiled
(utils/compiled.jit_step): on the card one CUDA graph, captured once and
replayed.  `t` is a 0-d f32 step counter that rides in the compiled
step's state on the device and is advanced inside it, so every replay
sees other inputs (a body adds 1e-9 t or 1e-6 t to its input, as the JAX
tool's bodies do) without a copy from the host.  Each of `reps` runs
times `n` back-to-back replays between two CUDA events, starting from an
idle card; the result is ms a replay, the least or the median over the
runs.  On the CPU the body is called as it is and timed by the host
clock.  The JAX tool's scan-length differencing, which cancels a relay's
round trip, has no counterpart: a replay has no round trip to cancel.

Rows, under the JAX tool's names, at 1080p YUV with `flagship_filter()`
(below 540 rows the dry run's tiny flagship, for CPU runs): the full
step, tracker.track, the luma and its detection resize, warp.apply at
1080p, the path smoother and features.detect.  `stages` is the function
chip_smoke.py calls in-process.  Rows are printed as the JAX tool prints
them; --json-out appends them as JSON lines.

Usage:
    python tools/profile_stages_torch.py [--device cuda|cpu] [--size 1080x1920]
        [--n 60] [--reps 3] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from serving_torch import (  # noqa: E402
    append,
    card_line,
    check_json_out,
    log,
    parse_size,
    serving_filter,
)

def graph_time(body, state, n: int = 60, reps: int = 3, stat: str = "min", device=None) -> float:
    """ms a call of `body(state, t) -> (state, out)` (module docstring):
    replays of its CUDA graph on the card, plain calls on the CPU, after
    one call (the capture).  `stat` is "min" or "median" over `reps` runs
    of `n` calls.  `device` (where `t` lives) defaults to the state's
    tensors' device; a state without tensors (None) needs it.  The graph
    and its memory pool are released before it returns."""
    import torch
    import torch.utils._pytree as pytree

    from livevisionkit_tpu_torch.utils.compiled import jit_step

    if stat not in ("min", "median"):
        raise ValueError(f"unknown stat {stat!r}")
    dev = torch.device(device) if device is not None else next(
        x.device for x in pytree.tree_leaves(state) if isinstance(x, torch.Tensor))

    def step(carry):
        st, t = carry
        st, out = body(st, t)
        return (st, t + 1.0), out

    carry = (state, torch.zeros((), dtype=torch.float32, device=dev))
    times = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            compiled = jit_step(step)
            carry, _ = compiled(carry)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            for _ in range(reps):
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(n):
                    carry, _ = compiled(carry)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / n)
            del compiled, carry
            gc.collect()
            torch.cuda.empty_cache()
    else:
        carry, _ = step(carry)
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                carry, _ = step(carry)
            times.append((time.perf_counter() - t0) * 1e3 / n)
    return min(times) if stat == "min" else statistics.median(times)


def time_rows(bodies, n: int, reps: int, stat: str = "min") -> list[tuple[str, float]]:
    """(name, ms) of each (name, body, state) that `bodies` yields."""
    return [(name, graph_time(body, state, n, reps, stat)) for name, body, state in bodies]


def noise(shape, seed: int = 0):
    """Uniform [0.1, 0.9) f32 host noise (the JAX tools' inputs)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, size=shape)
                            .astype(np.float32))


def bodies(filt, size: tuple[int, int] = (1080, 1920), device="cuda"):
    """(name, body, state) of each row: the stabilizer `filt` on a YUV
    frame of noise of `size`, and its stages, each from its own initial
    state."""
    import torch

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.ops import resample
    from livevisionkit_tpu_torch.vision import features, frame_tracker, path_smoother

    s = filt.settings
    res, det_size = s.tracker.motion_resolution, s.tracker.detection_size
    dev = torch.device(device)
    fmt = lt.PixelFormat.YUV
    pix = noise((3, *size)).to(dev)
    luma = pix[0]
    live = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def full_body(st, t):
        return filt.step(st, lt.Frame(pixels=pix + 1e-9 * t, timestamp=t, valid=live, format=fmt))

    yield "full step", full_body, filt.init(lt.FrameSpec(*size, 3, fmt), device=dev)

    def track_body(st, t):
        st, res_ = frame_tracker.track(st, luma + 1e-6 * t, s.tracker)
        return st, (res_.motion.offsets, res_.stability)

    yield "tracker.track", track_body, frame_tracker.init(s.tracker, device=dev)

    def resize_body(c, t):
        return c, resample.resize(luma + 1e-6 * t, det_size)

    yield "luma+detect resize", resize_body, zero

    wf = lt.WarpField.identity(res, device=dev)
    offsets = wf.offsets + 0.01

    def warp_body(c, t):
        return c, lt.WarpField(offsets=offsets + 1e-6 * t).apply(pix, fill=0.0)

    yield "warp.apply 1080p", warp_body, zero

    motion = lt.WarpField.identity(res, device=dev)

    def smooth_body(st, t):
        st, corr, _ = path_smoother.next_correction(
            st, lt.WarpField(offsets=motion.offsets + 1e-6 * t), s.smoother)
        return st, corr.offsets

    yield "smoother", smooth_body, path_smoother.init(s.smoother, res, device=dev)

    thresholds = features.initial_thresholds(s.tracker.detector, device=dev)
    g = resample.resize(luma, det_size)

    def detect_body(c, t):
        fs, thr = features.detect(g + 1e-6 * t, thresholds, s.tracker.detector)
        return c, (fs.points, fs.valid, thr)

    yield "features.detect", detect_body, zero


def stages(size: tuple[int, int] = (1080, 1920), device="cuda", n: int = 60,
           reps: int = 3) -> list[tuple[str, float]]:
    """The rows, (name, ms) in the JAX tool's order."""
    return time_rows(bodies(serving_filter(size), size, device), n, reps)


def show(name: str, ms: float) -> None:
    """A row as the JAX tool prints it."""
    print(f"{name + ':':22s}{ms:7.3f} ms", flush=True)


def main(argv=None) -> list[tuple[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    size = parse_size(args.size)
    card = card_line(args.device)
    log(f"profile_stages on {card}, {size[0]}x{size[1]}")
    rows = stages(size, args.device, args.n, args.reps)
    for name, ms in rows:
        show(name, ms)
        append({"tool": "profile_stages", "row": name, "ms": ms, "device": card,
                "size": f"{size[0]}x{size[1]}"}, args.json_out)
    return rows


if __name__ == "__main__":
    main()
