"""One live stream: `runtime.stream.stream` fed by an open-loop paced reader
(an OBS streamer's 1080p60 source).

The reader plays a host ring of 8-bit BGR frames: first
`closed_warmup_frames` as fast as they are taken (the graph's capture,
the stabilizer's delay, the in-flight window), then every frame due at its
slot of `fps`, released whether or not the pipeline has taken the last.
After `paced_warmup_frames` comes the window of `--seconds` x `fps`
inputs; each output a window input releases (the output showing input k
- delay) is timed from that input's due time to its arrival at
`on_output`, so a stall counts against every frame behind it.  A traced
run then plays a second, short session under the profiler (the profiler
starts and stops on the thread that calls `stream()`): `delay` + 2 inputs
as they are taken, then `trace_frames` paced ones."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import render
from harness.build import build_filter, pixel_format
from harness.judge import judge_samples, sample_maps
from harness.roofline import stabilizer_work
from harness.trace import Profiler
from reference import color
from reference.stabilizer import Chain, Inputs, bgr_inputs_to_yuv


def ring(cell, seed: int, stream: int, device):
    """Stream `stream`'s path and its ring as 8-bit BGR (T, H, W, 3) host
    frames."""
    size = tuple(cell.config["size"])
    n = render.ring_frames(cell.traffic, size)
    st = render.make_stream(seed, stream, n, size, cell.traffic, device)
    bgr = color.yuv_to_bgr(st.frames).clamp_(0.0, 1.0).mul_(255.0).add_(0.5).floor_()
    frames = bgr.to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return st.path, frames


def program_frames(filt, config: dict, frames: np.ndarray, device) -> dict:
    """The traced run's `run.program` of a live driver: the filter and a
    ring as the driver hands it to the filter (YUV planes, as the
    reference takes them, on the device)."""
    fmt = pixel_format(config)
    if fmt.name != "YUV":
        raise ValueError(f"the reference works on YUV frames, not {fmt.name}")
    return {"filter": filt, "frames": torch.stack([bgr_inputs_to_yuv(f, device=device) for f in frames]),
            "format": fmt}


def inputs(path, frames: np.ndarray, device) -> Inputs:
    """The reference's view of a ring played from its first frame on."""
    n = len(frames)
    return Inputs(poses=path.poses, frame=lambda r: bgr_inputs_to_yuv(frames[r], device=device),
                  ring_index=lambda g: g % n)


def _schedule(tr: dict, seconds: float) -> tuple[int, int, int]:
    """(first window input, window inputs, inputs in all but the trace)."""
    k0 = tr["closed_warmup_frames"] + tr["paced_warmup_frames"]
    n_win = int(round(seconds * tr["fps"]))
    return k0, n_win, k0 + n_win


def _picks(seed: int, k0: int, n_win: int, k: int) -> list[int]:
    rng = np.random.default_rng(render.stream_seed(seed, 1 << 20))
    return sorted(k0 + int(i) for i in rng.choice(n_win, size=min(n_win, k), replace=False))


def paced_reader(frames, total: int, closed: int, fps: float, due: np.ndarray):
    """(frame, timestamp) for inputs 0 .. total - 1 of the ring `frames`:
    the first `closed` as soon as they are taken, each later one at its
    due time, `fps` after the last, from the first paced input on.  A due
    time is fixed by the schedule, never by when the consumer took the last
    frame; `due[k]` records input k's (for a closed input: when it was
    yielded)."""
    t_paced = None
    for k in range(total):
        if k >= closed:
            if t_paced is None:
                t_paced = time.perf_counter()
            due[k] = t_paced + (k - closed) / fps
            wait = due[k] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        else:
            due[k] = time.perf_counter()
        yield frames[k % len(frames)], k / fps


def control_inputs(cell, seed: int, seconds: float, rate: float, device):
    """What a run would judge, for control.py (the paced reader offers the
    window's inputs at the mix's own rate; `rate` is not needed)."""
    path, frames = ring(cell, seed, 0, device)
    k0, n_win, _ = _schedule(cell.traffic, seconds)
    picks = [(0, g) for g in _picks(seed, k0, n_win, cell.traffic["samples"])]
    return [inputs(path, frames, device)], picks, color.yuv_to_bgr


def run(run) -> None:
    from livevisionkit_tpu_torch.runtime.stream import stream

    run.note("the port is loaded")
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    path, frames = ring(run.cell, run.seed, 0, dev)
    run.note("rendered the rings")
    filt = build_filter(cfg)
    delay, fps = filt.delay, float(tr["fps"])
    k0, n_win, k_end = _schedule(tr, run.seconds)
    due = np.zeros(k_end)
    arrived = np.full(k_end, np.nan)
    keep = set(_picks(run.seed, k0, n_win, tr["samples"]))
    kept: dict[int, np.ndarray] = {}

    def on_output(px, ts):
        t = time.perf_counter()
        rel = int(round(ts * fps)) + delay  # the input whose step released it
        if 0 <= rel < k_end:
            arrived[rel] = t
        if rel in keep:
            kept[rel] = np.array(px)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reader = paced_reader(frames, k_end, tr["closed_warmup_frames"], fps, due)
    stats = stream(filt, reader, on_output, queue_depth=tr["queue_depth"], inflight=tr["inflight"],
                   device=dev)
    win = slice(k0, k_end)
    lat = (arrived[win] - due[win]) * 1000.0
    got = lat[~np.isnan(lat)]
    run.end_to_end["setup_s"] = due[k0] - run.started
    run.end_to_end["latency_p50_ms"] = float(np.percentile(got, 50)) if got.size else float("inf")
    run.end_to_end["latency_p95_ms"] = float(np.percentile(got, 95)) if got.size else float("inf")
    run.attempted, run.failed = n_win, int(np.isnan(lat).sum())
    run.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    refs = [inputs(path, frames, dev)]
    if run.trace:
        if dev.type == "cuda":
            prof = Profiler()
            prof.start()
            stream(filt, paced_reader(frames, delay + 2 + tr["trace_frames"], delay + 2, fps,
                                      np.zeros(delay + 2 + tr["trace_frames"])),
                   queue_depth=tr["queue_depth"], inflight=tr["inflight"], device=dev)
            prof.stop()
            run.slice = prof.read()
        run.work = stabilizer_work(cfg, sample_maps(cfg, refs, k_end - 1, dev), 1)
        # stats.latencies holds one sample per valid output, in order: the
        # output released by input k is the (k - delay)-th.
        run.program = {**program_frames(filt, cfg, frames, dev),
                       "driver_latencies": stats.latencies[k0 - delay:k_end - delay]}
        run.read_layers()
        run.program = {}
    del filt, stats
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge_samples(run, [Chain(cfg, refs[0], device=dev)], [(0, g, px) for g, px in sorted(kept.items())],
                  to_output=color.yuv_to_bgr)
