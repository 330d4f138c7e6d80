"""Offline clip: the library's `runtime.offline.process_clip` called back to
back over one clip held on the card, the state carried from call to call
(an editor stabilizing a recorded clip).

Set-up renders the clip (a closed path, so the next call's first frame
follows the last as one more shake) and runs one call over the clip's last
`warmup_frames` frames from a fresh state: the kernel library, the
per-shape caches, the tracker's trust ramp and the stabilizer's delay are
all behind it.  The window then calls `process_clip` over the whole clip
until `--seconds` have passed; the rate (the mix's `rate_metric`) is the
frames of those calls over their time (each call waits for its last frame).  Every output of a
call is checked for its valid flag and its timestamp, and
`samples_per_call` of them, drawn from the seed, are kept for the
reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import render
from harness.build import build_filter, pixel_format
from harness.judge import judge_samples, sample_maps
from harness.roofline import stabilizer_work
from harness.trace import Profiler
from reference.stabilizer import Chain, Inputs


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stream(cell, seed: int, device):
    size = tuple(cell.config["size"])
    n = render.ring_frames(cell.traffic, size)
    return render.make_stream(seed, 0, n, size, cell.traffic, device), n


def _inputs(stream, n: int, w0: int) -> Inputs:
    """The program's g-th input is clip frame (g - w0) mod n: set-up played
    the last w0 frames, every call after it the whole clip."""
    return Inputs(poses=stream.path.poses, frame=lambda r: stream.frames[r],
                  ring_index=lambda g: (g - w0) % n)


def _picker(seed: int):
    return np.random.default_rng(render.stream_seed(seed, 1 << 20))


def _pick(picker, n: int, k: int) -> list[int]:
    """The outputs of one call kept for the reference."""
    return sorted(int(i) for i in picker.choice(n, size=min(n, k), replace=False))


def control_inputs(cell, seed: int, seconds: float, rate: float, device):
    """What a run would judge, for control.py: the calls of a window at
    `rate` (the cell's frames a second in a sound run; a run calls until
    the window has passed, so it makes one call more than fit), with
    `samples_per_call` outputs drawn from each as a run draws them."""
    if rate is None:
        raise ValueError("the clip driver's control needs the cell's rate (--rate)")
    stream, n = _stream(cell, seed, device)
    w0, tr = cell.traffic["warmup_frames"], cell.traffic
    picker = _picker(seed)
    calls = int(seconds * rate // n) + 1
    picks = [(0, w0 + c * n + i) for c in range(calls) for i in _pick(picker, n, tr["samples_per_call"])]
    return [_inputs(stream, n, w0)], picks, None


def run(run) -> None:
    from livevisionkit_tpu_torch.runtime.offline import process_clip

    run.note("the port is loaded")
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    stream, n = _stream(run.cell, run.seed, dev)
    clip = stream.frames
    run.note(f"rendered {n} frames")
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

    inputs = _inputs(stream, n, w0)
    if run.trace:
        k = tr["trace_frames"]
        run.work = stabilizer_work(cfg, sample_maps(cfg, [inputs], g0 - 1, dev), 1)
        if dev.type == "cuda":
            prof = Profiler()
            prof.start()
            state, out = process_clip(filt, clip[:k], fmt, ts[:k], state=state, device=dev)
            _sync(dev)
            prof.stop()
            del out
            run.slice = prof.read()
        run.program = {"filter": filt, "frames": clip, "format": fmt}
        run.read_layers()
        run.program = {}
    del state, filt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge_samples(run, [Chain(cfg, inputs, device=dev)], samples)
