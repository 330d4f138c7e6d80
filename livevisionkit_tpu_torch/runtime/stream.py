"""Streaming pipeline: decode -> device step -> encode, fully overlapped
(counterpart of livevisionkit_tpu/runtime/stream.py).

Reference parity: ``VideoFilter::stream`` (reference Filters/VideoFilter
.cpp:62-209) — a 3-thread pipeline (reader / filter / output threads, two
15-deep bounded queues with backpressure, early-termination draining) —
and the CLI driver ``VideoProcessor::run`` (reference
Modules/VideoEditor/VideoProcessor.cpp:148-230).

The pipeline (reader and writer threads, the step around the filter, the
in-flight window, the shutdown) is runtime/pipeline.py's, shared with the
multi-stream driver; on a CUDA device its step is ONE CUDA graph replayed a
frame (utils/compiled.jit_step), as the JAX runtime dispatches one compiled
program a frame.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import CompositeFilter, VideoFilter
from livevisionkit_tpu_torch.runtime import pipeline
from livevisionkit_tpu_torch.runtime.hud import draw_frame_time_hud
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.compiled import jit_step
from livevisionkit_tpu_torch.utils import profiling
from livevisionkit_tpu_torch.utils.profiling import Stopwatch, trace_scope


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    # The call's span table and counters (utils/profiling.py).
    session: profiling.Session = field(default_factory=lambda: profiling.Session("stream"))
    # Per-filter device-synced timings, only in profile mode (reference
    # VideoProcessor -v, VideoProcessor.cpp:291-356).
    filter_times: dict = field(default_factory=dict)
    # Per-output submit -> hand-over latency samples (seconds): from the end
    # of the frame's submission to its pixels being host-resident and handed
    # to the writer, which is as soon as their copy has completed (in-flight
    # outputs wait only for older ones).  The stabilizer's algorithmic delay
    # (its delay queue) is not included.
    latencies: list = field(default_factory=list)

    @property
    def frame_time(self) -> Stopwatch:
        """The session's `frame` spans (a frame's wait for its input and its
        work) past the first, which builds the state and captures the step:
        the intervals between frames, one fewer than the frames."""
        return self.session.watch("frame", skip=1)

    @property
    def fps(self) -> float:
        avg = self.frame_time.average()
        return 1.0 / avg if avg > 0 else 0.0

    def latency_quantiles(self) -> dict:
        """p50/p95/p99 frame latency in ms (empty dict when no samples)."""
        if not self.latencies:
            return {}
        arr = np.sort(np.asarray(self.latencies)) * 1e3
        q = lambda p: float(arr[min(len(arr) - 1, int(p * len(arr)))])  # noqa: E731
        return {"p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99)}


def stream(
    filt: VideoFilter,
    reader,
    on_output: Callable[[np.ndarray, float], None] | None = None,
    work_format: PixelFormat = PixelFormat.YUV,
    queue_depth: int = 15,
    inflight: int = 3,
    max_frames: int | None = None,
    stop_event: threading.Event | None = None,
    profile_filters: bool = False,
    hud_budget_ms: float | None = None,
    device: torch.device | str = "cuda",
    jit: bool = True,
) -> StreamStats:
    """Run `filt` over `reader` (yields (bgr_hwc_uint8, timestamp)) on
    `device`.

    on_output receives (planar_float_bgr (3,H,W), timestamp) for every VALID
    output frame, in order, from the writer thread.  Conversion into/out of
    `work_format` happens on the device around the filter, mirroring the
    reference's YUV inter-filter convention (Filters/VideoFilter.hpp:31).

    profile_filters steps each element of a CompositeFilter on its own (one
    graph per element) and waits for the device after each, timing it
    under "i:name" in `filter_times` (the reference's sync-to-measure,
    Stopwatch.cpp:127-131); it costs the pipelining.  `jit=False` runs
    every step op by op (the same arithmetic; for timing and debugging).
    hud_budget_ms enables the reference's test-mode frame-time HUD
    (VSFilter.cpp:368-383): the host-measured frame time is stamped onto
    every output, green within budget / red over (runtime/hud.py).

    The call is one session of utils/profiling.py (kind "stream"), returned
    as `StreamStats.session`: a `frame` span a frame (its `read_wait`, then
    `upload`, `replay`, `download`, `drain_wait`, with `deliver` wherever an
    output is handed over, `read_wait` included) inside `loop`, `read` /
    `write` in the reader and writer threads, and the window's counters
    `window.outputs` and `window.early` (runtime/pipeline.py).
    """
    device = torch.device(device)
    with profiling.session("stream") as sess:
        stats = StreamStats(session=sess)
        _run(stats, filt, reader, on_output, work_format, queue_depth, inflight, max_frames,
             stop_event or threading.Event(), profile_filters, hud_budget_ms, device, jit)
        sess.frames = stats.frames_in
    return stats


def _run(stats, filt, reader, on_output, work_format, queue_depth, inflight, max_frames,
         stop_event, profile_filters, hud_budget_ms, device, jit) -> None:
    """`stream`'s pipeline, inside its session."""
    sess = stats.session
    bgr = PixelFormat.BGR
    live = torch.ones((), dtype=torch.bool, device=device)

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sub_filters = (
        list(filt.filters) if profile_filters and isinstance(filt, CompositeFilter) else None
    )
    if sub_filters is not None:
        sub_keys = [f"{i}:{f.name}" for i, f in enumerate(sub_filters)]
        sub_steps = [jit_step(f.step) if jit else f.step for f in sub_filters]
        for k in sub_keys:
            stats.filter_times[k] = Stopwatch()

    device_step = pipeline.device_step(filt, work_format)

    def full_step(state, raw, meta):
        return device_step(state, raw, meta[0], live, False)

    def profile_step(state, raw, meta):
        """Each filter of the chain stepped and waited for on its own."""
        frame = Frame(pixels=pipeline.ingest(raw), timestamp=meta[0], valid=live,
                      format=bgr).reformat(work_format)
        wait()  # the first filter's time is its own
        new_states = []
        for k, sub_step, sub_state in zip(sub_keys, sub_steps, state):
            watch = stats.filter_times[k]
            watch.start()
            with trace_scope(k):
                sub_state, frame = sub_step(sub_state, frame)
                wait()
            watch.stop()
            new_states.append(sub_state)
        frame = frame.reformat(bgr)
        return tuple(new_states), (frame.pixels, frame.timestamp, frame.valid)

    compiled = jit_step(full_step) if jit and sub_filters is None else None
    step = compiled or full_step

    state = window = None
    inputs = None  # the compiled step's static (raw, meta), once captured

    def deliver(host, t_submit):
        px, ts, valid = host
        with trace_scope("deliver"):
            if not bool(valid):
                return
            out_np = px.numpy()
            stats.latencies.append(time.perf_counter() - t_submit)
            if hud_budget_ms is not None:
                out_np = draw_frame_time_hud(np.array(out_np), sess.last("frame") * 1e3, hud_budget_ms)
            stats.frames_out += 1
            io.put(io.out_qs[0], (out_np, float(ts)))

    with pipeline.Threads(sess, [reader], [on_output], stop_event, queue_depth, max_frames) as io:
        with trace_scope("loop"):
            while True:
                # A frame's span: its wait for the input, then its work
                # (profiler spans too while tracing: the CLI's --trace).
                frame_span = trace_scope("frame", stats.frames_in)
                with frame_span:
                    with trace_scope("read_wait"):
                        item = io.get(0, idle=None if window is None else lambda: window.poll(deliver))
                    if item is None:
                        frame_span.discard()
                        break
                    raw_np, ts = item
                    if state is None:
                        state = filt.init(pipeline.frame_spec(raw_np, work_format), device=device)
                        window = pipeline.Window([(raw_np.shape, torch.uint8), ((1,), torch.float32)],
                                                 device, inflight)
                    with trace_scope("upload"):
                        raw_h, ts_h = window.host()
                        raw_h[...] = raw_np
                        ts_h[0] = ts
                        raw, meta = window.send(inputs)
                    with trace_scope("replay"):
                        if sub_filters is None:
                            state, out = step(state, raw, meta)
                            if compiled is not None and inputs is None:
                                inputs = compiled.static_inputs(state, raw, meta)
                        else:
                            state, out = profile_step(state, raw, meta)
                    stats.frames_in += 1
                    window.push(out, deliver)
        if window is not None:
            window.drain(deliver)
