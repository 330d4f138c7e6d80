"""Offline clip over a two-plane scene: the clip driver's window and
sampling (`drivers/clip.py`: `process_clip` back to back over one clip on
the card, the state carried, `samples_per_call` outputs of each call kept
for the reference) over a stream with a nearer foreground plane
(`harness/render_parallax.py`), judged plane by plane against the
two-plane reference (`harness/judge_planes.py`).

The traced run also hands the readers the traced `process_clip` session
(`run.program["session"]`, None where the program keeps none), whose
counters the tracker's mesh readers read."""

from __future__ import annotations

import time

import torch

from drivers.clip import _pick, _picker, _sync
from harness import render, render_parallax
from harness.build import build_filter, pixel_format
from harness.judge_planes import judge_plane_samples
from harness.trace import Profiler
from reference.parallax import PlaneChain, PlaneInputs


def _stream(cell, seed: int, device):
    size = tuple(cell.config["size"])
    n = render.ring_frames(cell.traffic, size)
    return render_parallax.make_stream(seed, 0, n, size, cell.traffic, device), n


def _inputs(stream, n: int, w0: int) -> PlaneInputs:
    """The program's g-th input is clip frame (g - w0) mod n, as in the clip
    driver."""
    return PlaneInputs(poses=stream.path.poses, frame=lambda r: stream.frames[r],
                       ring_index=lambda g: (g - w0) % n, fg_poses=stream.fg_poses, fg_rect=stream.fg_rect)


def control_inputs(cell, seed: int, seconds: float, rate: float, device):
    """What a run would judge (the clip driver's `control_inputs` over this
    stream), for control_parallax.py."""
    if rate is None:
        raise ValueError("the clip driver's control needs the cell's rate (--rate)")
    stream, n = _stream(cell, seed, device)
    w0, tr = cell.traffic["warmup_frames"], cell.traffic
    picker = _picker(seed)
    calls = int(seconds * rate // n) + 1
    picks = [(0, w0 + c * n + i) for c in range(calls) for i in _pick(picker, n, tr["samples_per_call"])]
    return [_inputs(stream, n, w0)], picks, None


def _last_session():
    from livevisionkit_tpu_torch.utils import profiling

    found = profiling.sessions()
    return found[-1] if found else None


def run(run) -> None:
    from livevisionkit_tpu_torch.runtime.offline import process_clip

    run.note("the port is loaded")
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    stream, n = _stream(run.cell, run.seed, dev)
    clip = stream.frames
    run.note(f"rendered {n} frames over two planes")
    ts = torch.arange(n, dtype=torch.float32, device=dev) / float(tr["fps"])
    filt, fmt = build_filter(cfg), pixel_format(cfg)
    delay = filt.delay
    w0 = tr["warmup_frames"]
    state, out = process_clip(filt, clip[n - w0:], fmt, ts[n - w0:], device=dev)
    del out
    _sync(dev)
    run.note("warm-up call done")

    # The i-th output of a call shows clip frame (i - delay) mod n.
    want_ts = ts[torch.remainder(torch.arange(n, device=dev) - delay, n)]
    picker = _picker(run.seed)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    samples, frames, busy, g0 = [], 0, 0.0, w0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    run.end_to_end["setup_s"] = t_window - run.started
    while True:
        t0 = time.perf_counter()
        state, out = process_clip(filt, clip, fmt, ts, state=state, device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        busy += t1 - t0
        frames += n
        run.note(f"call of {n} frames: {t1 - t0:.4f} s")
        bad += ((~out.valid) | (out.timestamp != want_ts)).sum()
        for i in _pick(picker, n, tr["samples_per_call"]):
            samples.append((0, g0 + i, out.pixels[i].clone()))
        del out
        g0 += n
        _sync(dev)
        if t1 - t_window >= run.seconds:
            break
    run.end_to_end[tr["rate_metric"]] = frames / busy
    run.attempted, run.failed = frames, int(bad)
    run.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if run.trace:
        k = tr["trace_frames"]
        session = None
        if dev.type == "cuda":
            prof = Profiler()
            prof.start()
            state, out = process_clip(filt, clip[:k], fmt, ts[:k], state=state, device=dev)
            _sync(dev)
            prof.stop()
            del out
            run.slice = prof.read()
            session = _last_session()
        run.program = {"filter": filt, "frames": clip, "format": fmt, "session": session}
        run.read_layers()
        run.program = {}
    del state, filt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge_plane_samples(run, [PlaneChain(cfg, _inputs(stream, n, w0), device=dev)], samples)
