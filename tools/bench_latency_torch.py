"""Live-mode frame latency of the PyTorch port: p50/p95/p99 submit ->
host-resident through `runtime/stream.stream()` fed by a paced reader (the
counterpart of tools/bench_latency.py).

The reader yields u8 BGR frames at --fps (<= 0: unpaced, the queue's
backpressure sets the rate).  Two pipelines run, an identity filter and
the flagship stabilizer, each as one `stream()` call over --warmup frames
and then --frames frames: `stream()` captures its CUDA graph at its first
frame, so the warm-up frames lead the measured ones in the same call and
only the last --frames outputs count (the JAX tool's measured pass reuses
its warm-up's compile instead).  A pipeline row holds the quantiles
against the live limit of (inflight + 1) frame periods at 60 fps, 66.7 ms
for the default window of 3.  `stream()` hands each output over as
soon as its copy has completed, so from a paced reader the latency is the
step, the download and the hand-over, well under a frame period;
--inflight caps the outputs in flight and waits on the oldest only beyond
it, which a reader faster than the step reaches.  The `vs_minus_identity`
row gives the stabilizer-minus-identity quantiles (the transfer floor
cancelled), the per-frame compute they imply (the p50 difference), the
time of the same per-frame program as a `jit_step` graph
(`graph_step_ms`: the pinned u8 upload, BGR -> YUV, the stabilizer's
step, YUV -> BGR; CUDA events on the card, the host clock on the CPU;
the JAX tool's scan-differenced step), the stabilizer's delay queue in
frames and in ms at 60 fps, and the reference's 6 ms budget
(VSFilter.cpp:71,380).

`latency` is the function chip_smoke.py calls in-process; rows go to
stdout as JSON lines, progress to stderr.

Usage:
    python tools/bench_latency_torch.py [--device cuda|cpu] [--fps 60] [--frames 120]
        [--warmup 60] [--inflight 3] [--size 1080x1920] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from serving_torch import emit, log, parse_size, random_ring, serving_filter  # noqa: E402

REFERENCE_BUDGET_MS = 6.0
GRAPH_REPS = 30


def paced_reader(frames: list, fps: float, n: int):
    """n (frame, timestamp) pairs from the ring `frames`, the t-th released
    at t / fps seconds after the first (fps <= 0: as fast as taken)."""
    period = 1.0 / fps if fps > 0 else 0.0
    t0 = time.perf_counter()
    for t in range(n):
        if period:
            wait = t0 + t * period - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        yield frames[t % len(frames)], t * (period or 1.0 / 60.0)


def run_pipeline(name: str, filt, ring: list, fps: float, warmup: int, frames: int, inflight: int,
                 device="cuda") -> dict:
    """One `stream()` call over warmup + frames paced frames: the row of
    its last `frames` outputs."""
    from livevisionkit_tpu_torch.runtime.stream import StreamStats, stream

    if warmup < getattr(filt, "delay", 0):
        raise ValueError(f"{name}: the warm-up must cover the filter's delay of {filt.delay} frames")
    arrivals = []
    log(f"{name}: {warmup} warm-up + {frames} frames at {fps} fps ...")
    stats = stream(filt, paced_reader(ring, fps, warmup + frames),
                   on_output=lambda px, ts: arrivals.append(time.perf_counter()),
                   inflight=inflight, device=device)
    assert stats.frames_in == warmup + frames, f"{name}: {stats.frames_in} frames in"
    assert len(arrivals) == stats.frames_out >= frames, f"{name}: {len(arrivals)} outputs"
    window = arrivals[-frames:]
    quant = StreamStats(latencies=stats.latencies[-frames:]).latency_quantiles()
    limit = (inflight + 1) * 1000.0 / 60.0
    return {"config": name, "device": str(device), "size": "x".join(map(str, ring[0].shape[:2])),
            "paced_fps": fps, "inflight": inflight, "frames": frames,
            "achieved_fps": (len(window) - 1) / (window[-1] - window[0]), **quant,
            "limit_ms": limit, "met": quant["p99_ms"] <= limit}


def graph_step_ms(filt, frame_u8, device="cuda") -> float:
    """ms of the per-frame program of `stream()` as one `jit_step` graph,
    over GRAPH_REPS replays after its capture: a non-blocking upload of the
    pinned u8 HWC BGR frame, its repack and conversion to YUV, the
    filter's step and the conversion back to BGR."""
    import torch

    from livevisionkit_tpu_torch.data.frame import Frame
    from livevisionkit_tpu_torch.filters.base import FrameSpec
    from livevisionkit_tpu_torch.runtime.pipeline import ingest
    from livevisionkit_tpu_torch.types import PixelFormat
    from livevisionkit_tpu_torch.utils.compiled import jit_step

    cuda = torch.device(device).type == "cuda"
    bgr, yuv = PixelFormat.BGR, PixelFormat.YUV
    live = torch.ones((), dtype=torch.bool, device=device)

    def full_step(state, raw, stamp):
        frame = Frame(pixels=ingest(raw), timestamp=stamp, valid=live, format=bgr).reformat(yuv)
        state, out = filt.step(state, frame)
        out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    h, w = frame_u8.shape[:2]
    host = torch.from_numpy(frame_u8).pin_memory() if cuda else torch.from_numpy(frame_u8)
    raw = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
    stamps = torch.arange(GRAPH_REPS + 1, dtype=torch.float32, device=device) / 60.0
    step = jit_step(full_step)
    state = filt.init(FrameSpec(h, w, 3, yuv), device=device)

    def one(t, state):
        raw.copy_(host, non_blocking=cuda)
        return step(state, raw, stamps[t])[0]

    state = one(0, state)  # the capture
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for t in range(1, GRAPH_REPS + 1):
        state = one(t, state)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / GRAPH_REPS
    return (time.perf_counter() - t0) * 1e3 / GRAPH_REPS


def latency(filt, size: tuple[int, int], frames: int = 120, fps: float = 60.0, warmup: int = 60,
            inflight: int = 3, device="cuda") -> list:
    """The identity row, the stabilizer's row and the `vs_minus_identity`
    row (module docstring)."""
    from livevisionkit_tpu_torch.filters.base import CompositeFilter, IdentityFilter

    ring = random_ring(size, n=8)
    ident = run_pipeline("identity_pipeline_floor", CompositeFilter((IdentityFilter(),)), ring, fps,
                         warmup, frames, inflight, device)
    vs = run_pipeline(f"vs_{size[0]}p_latency", CompositeFilter((filt,)), ring, fps, warmup, frames,
                      inflight, device)
    keys = ("p50_ms", "p95_ms", "p99_ms")
    delay = filt.settings.smoother.predictive_samples
    delta = {"config": "vs_minus_identity", "device": str(device), "size": vs["size"],
             "paced_fps": fps, "inflight": inflight, **{k: vs[k] - ident[k] for k in keys},
             "per_frame_compute_ms_est": vs["p50_ms"] - ident["p50_ms"],
             "graph_step_ms": graph_step_ms(filt, ring[0], device),
             "delay_queue_frames": delay, "delay_queue_ms_at_60fps": delay * 1000.0 / 60.0,
             "reference_budget_ms": REFERENCE_BUDGET_MS}
    return [ident, vs, delta]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=60)
    ap.add_argument("--fps", type=float, default=60.0, help="paced reader fps; <= 0: unpaced")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--inflight", type=int, default=3,
                    help="the pipeline's in-flight window (depth = inflight + 1)")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args()

    size = parse_size(args.size)
    for row in latency(serving_filter(size), size, args.frames, args.fps, args.warmup,
                       args.inflight, args.device):
        emit(row, args.json_out)


if __name__ == "__main__":
    main()
