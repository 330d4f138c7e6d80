"""Several live streams: `runtime.multistream.stream_multi` fed by
closed-loop readers, each yielding its next frame as soon as the driver
takes the last (a serving host stabilizing `streams` streams on one card).

Each stream plays its own host ring of 8-bit BGR frames (its own texture
and path).  The window opens when a reader first yields its
`warmup_frames`-th frame and lasts `--seconds`; readers stop at its end
(the driver then flushes every stream's delay queue).  The rate (the
mix's `rate_metric`) is the valid outputs delivered inside the window, all
streams together, over its length.  A frame offered inside the window counts as attempted, and
as failed if its output never comes.  Each stream's outputs for the
reference are drawn from all those its window inputs released
(`Reservoir`).  A traced run then plays a second,
short session of `trace_frames` inputs a stream under the profiler (which
starts and stops on the thread that calls `stream_multi`)."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from drivers.live import inputs, program_frames, ring
from harness import render
from harness.build import build_filter
from harness.judge import judge_samples, sample_maps
from harness.roofline import stabilizer_work
from harness.trace import Profiler
from reference import color
from reference.stabilizer import Chain

def _picker(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(render.stream_seed(seed, (1 << 20) + stream))


class Reservoir:
    """`k` outputs of one stream drawn evenly, by a generator seeded from the
    run's seed, from all those released by its window inputs (reservoir
    sampling: the i-th candidate replaces a kept one with chance k / i)."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k, self.seen = rng, k, 0
        self.kept: dict[int, np.ndarray] = {}
        self.order: list[int] = []

    def offer(self, g: int, px) -> None:
        self.seen += 1
        if len(self.order) < self.k:
            slot = len(self.order)
            self.order.append(g)
        else:
            slot = int(self.rng.integers(self.seen))
            if slot >= self.k:
                return
            del self.kept[self.order[slot]]
            self.order[slot] = g
        self.kept[g] = np.array(px)


def control_inputs(cell, seed: int, seconds: float, rate: float, device):
    """What a run would judge, for control.py: each stream's window offers
    `seconds` x `rate` / streams inputs (`rate`: the cell's frames a second
    in a sound run), of which `samples_per_stream` are drawn."""
    if rate is None:
        raise ValueError("the multi-stream driver's control needs the cell's rate (--rate)")
    tr = cell.traffic
    n_streams, w0, k = tr["streams"], tr["warmup_frames"], tr["samples_per_stream"]
    n = max(k, int(seconds * rate / n_streams))
    refs, picks = [], []
    for s in range(n_streams):
        path, frames = ring(cell, seed, s, device)
        refs.append(inputs(path, frames, device))
        picks += [(s, w0 + int(i)) for i in sorted(_picker(seed, s).choice(n, size=k, replace=False))]
    return refs, picks, color.yuv_to_bgr


class _Window:
    """The window's bounds, opened by the first reader to reach it."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.lock = threading.Lock()
        self.start = None

    def open(self) -> None:
        with self.lock:
            if self.start is None:
                self.start = time.perf_counter()

    def end(self) -> float:
        return self.start + self.seconds


def run(run) -> None:
    from livevisionkit_tpu_torch.runtime.multistream import stream_multi

    run.note("the port is loaded")
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    n_streams, w0 = tr["streams"], tr["warmup_frames"]
    rings = [ring(run.cell, run.seed, s, dev) for s in range(n_streams)]
    run.note("rendered the rings")
    filt = build_filter(cfg)
    delay, fps = filt.delay, float(tr["fps"])
    window = _Window(run.seconds)
    offered = [[] for _ in range(n_streams)]  # yield time of each input
    arrived = [{} for _ in range(n_streams)]  # releasing input -> arrival time
    kept = [Reservoir(_picker(run.seed, s), tr["samples_per_stream"]) for s in range(n_streams)]

    def reader(s):
        frames = rings[s][1]
        k = 0
        while True:
            if k == w0:
                window.open()
            if k >= w0 and time.perf_counter() >= window.end():
                break
            offered[s].append(time.perf_counter())
            yield frames[k % len(frames)], k / fps
            k += 1

    def on_output(s, px, ts):
        t = time.perf_counter()
        rel = int(round(ts * fps)) + delay
        arrived[s][rel] = t
        # Released by an input of the window: one the reader has yielded
        # (the flush after the last input releases outputs by bubbles,
        # which no input released).
        if w0 <= rel < len(offered[s]):
            kept[s].offer(rel, px)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stream_multi(filt, [reader(s) for s in range(n_streams)], on_output, device=dev,
                 queue_depth=tr["queue_depth"], inflight=tr["inflight"])
    t0, t1 = window.start, window.end()
    delivered = attempted = failed = 0
    for s in range(n_streams):
        delivered += sum(1 for t in arrived[s].values() if t0 <= t <= t1)
        for k, t in enumerate(offered[s]):
            if k >= w0 and t0 <= t <= t1:
                attempted += 1
                failed += k not in arrived[s]
    run.end_to_end["setup_s"] = t0 - run.started
    run.end_to_end[tr["rate_metric"]] = delivered / run.seconds
    run.attempted, run.failed = attempted, failed
    run.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    refs = [inputs(path, frames, dev) for path, frames in rings]
    if run.trace:
        if dev.type == "cuda":
            short = [iter([(f[k % len(f)], k / fps) for k in range(tr["trace_frames"])]) for _, f in rings]
            prof = Profiler()
            prof.start()
            stream_multi(filt, short, device=dev, queue_depth=tr["queue_depth"], inflight=tr["inflight"])
            prof.stop()
            run.slice = prof.read()
        run.frames_per_replay = n_streams
        run.program = program_frames(filt, cfg, rings[0][1], dev)
        run.work = stabilizer_work(cfg, sample_maps(cfg, refs, w0, dev), n_streams)
        run.read_layers()
        run.program = {}
    del filt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chains = [Chain(cfg, r, device=dev) for r in refs]
    samples = [(s, g, px) for s in range(n_streams) for g, px in sorted(kept[s].kept.items())]
    judge_samples(run, chains, samples, to_output=color.yuv_to_bgr)
