"""Multi-stream end-to-end driver: S decoders -> one batched step per frame
tick -> S encoders (counterpart of livevisionkit_tpu/runtime/multistream.py).

The reference runs one ``VideoFilter::stream`` pipeline per filter
instance (Filters/VideoFilter.cpp:62-209); serving S videos there means S
processes with no shared batching.  Here the S streams batch into ONE step
per tick (parallel/streams.py): the step's launches, the warp's and LK's
included, are paid once per tick for all S streams.

Design, as in the JAX package, on runtime/pipeline.py's threads (a reader
and a writer a stream), step and in-flight window, shared with the solo
driver:
  * the main loop assembles a LOCKSTEP BATCH, one frame per live stream,
    uploads it as one (S, H, W, 3) u8 tensor and runs the batched step
    without waiting for the device: on the card one CUDA graph a tick
    (utils/compiled.jit_step), as the JAX runtime dispatches one compiled
    program a tick;
  * a stream that ended keeps its slot with valid=False bubbles flagged
    drain=True, so its delay-queue residue emits while the others run; a
    stream that is merely slow gets drain=False bubbles, which FREEZE its
    temporal state (no frame is lost);
  * the per-tick timestamps and flags ride in the frames' upload, so the
    loop makes no synchronizing copy, and `drain` is a per-stream device
    flag: one graph serves live, stalled and draining ticks.
"""

from __future__ import annotations

import functools
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from livevisionkit_tpu_torch.filters.base import VideoFilter
from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter, batched
from livevisionkit_tpu_torch.runtime import pipeline
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.compiled import jit_step
from livevisionkit_tpu_torch.utils import profiling
from livevisionkit_tpu_torch.utils.profiling import Stopwatch, trace_scope


@dataclass
class MultiStreamStats:
    frames_in: int = 0  # total decoded frames across streams
    frames_out: int = 0  # total valid emitted frames
    batches: int = 0
    stalls: int = 0  # bubbles injected for slow (not ended) streams
    per_stream_out: list = field(default_factory=list)
    graphs: int = 0  # CUDA graphs captured (0 op by op and on the CPU)
    # The call's span table and counters (utils/profiling.py).
    session: profiling.Session = field(default_factory=lambda: profiling.Session("multi"))

    @property
    def batch_time(self) -> Stopwatch:
        """The session's `tick` spans (a tick's wait for its frames and its
        work) past the first, which builds the state and captures the step."""
        return self.session.watch("tick", skip=1)


def stream_multi(
    filt: VideoFilter,
    readers: Sequence,
    on_output: Callable[[int, np.ndarray, float], None] | None = None,
    device: torch.device | str = "cuda",
    work_format: PixelFormat = PixelFormat.YUV,
    queue_depth: int = 15,
    inflight: int = 3,
    max_frames: int | None = None,
    stop_event: threading.Event | None = None,
    flush: bool = True,
    slow_stream_timeout: float | None = 0.25,
    jit: bool = True,
) -> MultiStreamStats:
    """Run `filt` over S concurrent `readers` (each yields
    (bgr_hwc_uint8, timestamp)) on `device`.

    on_output(stream_idx, planar_float_bgr (3,H,W), timestamp) is called from
    per-stream writer threads for every VALID output frame, in stream order.

    `slow_stream_timeout`: a stream whose decoder has no frame ready within
    this many seconds gets a valid=False bubble for THIS batch instead of
    stalling the other S-1 streams (no frame is dropped: its next frame
    rides a later batch).  None restores strict lockstep.  The first frame
    of each stream is always waited for (it defines the slot shape).
    `jit=False` steps op by op (the same arithmetic).

    The call is one session of utils/profiling.py (kind "multi"), returned
    as `MultiStreamStats.session`: a `tick` span a tick (its `read_wait`,
    then `assemble`, `upload`, `replay`, `download`, `drain_wait`, with
    `fanout` wherever a tick's outputs are handed over, `read_wait`
    included) inside `loop`, `read` / `write` in the reader and writer
    threads, and the window's counters `window.outputs` and `window.early`
    (runtime/pipeline.py).
    """
    device = torch.device(device)
    with profiling.session("multi") as sess:
        stats = MultiStreamStats(per_stream_out=[0] * len(readers), session=sess)
        _run(stats, filt, readers, on_output, device, work_format, queue_depth, inflight, max_frames,
             stop_event or threading.Event(), flush, slow_stream_timeout, jit)
        sess.frames, sess.ticks = stats.frames_in, stats.batches
    return stats


def _run(stats, filt, readers, on_output, device, work_format, queue_depth, inflight, max_frames,
         stop_event, flush, slow_stream_timeout, jit) -> None:
    """`stream_multi`'s pipeline, inside its session."""
    n = len(readers)
    sess = stats.session
    multi = MultiStreamFilter(filt, n)

    # `drain` is a per-stream flag: an EOF'd slot DRAINS its delay queue
    # (bubbles advance it with identity motion, emitting the residue while
    # other streams still run), a merely stalled slot FREEZES it (no frame
    # loss; see VideoFilter.step).  The terminal flush drains all.
    batch_step = batched(pipeline.device_step(filt, work_format))

    def tick(state, raw_u8, meta):
        """One tick from the upload: (S, H, W, 3) u8 frames and the (S, 3)
        f32 block of (timestamp, live, drain)."""
        return batch_step(state, raw_u8, meta[:, 0], meta[:, 1] > 0.5, meta[:, 2] > 0.5)

    compiled = jit_step(tick) if jit else None
    step = compiled or tick

    states = window = None
    inputs = None  # the compiled step's static (frames, meta), once captured

    def run(raws, tss, lives, drains):
        """Upload one tick and step it."""
        nonlocal states, inputs
        with trace_scope("assemble"):
            frames, meta = window.host()
            np.stack(raws, out=frames)
            meta[:] = np.stack([tss, lives, drains], axis=1)
        with trace_scope("upload"):
            frames, meta = window.send(inputs)
        with trace_scope("replay"):
            states, out = step(states, frames, meta)
            if compiled is not None and inputs is None:
                inputs = compiled.static_inputs(states, frames, meta)
        stats.batches += 1
        window.push(out, fanout)

    def fanout(host, _t_submit):
        px, ts, valid = host
        with trace_scope("fanout"):
            valid_np = valid.numpy()
            if not valid_np.any():
                return
            px_np, ts_np = px.numpy(), ts.numpy()
            for i in range(n):
                if valid_np[i]:
                    stats.frames_out += 1
                    stats.per_stream_out[i] += 1
                    io.put(io.out_qs[i], (px_np[i], float(ts_np[i])))

    eof = [False] * n
    drained = [0] * n  # batches dispatched since stream i's EOF
    last_frame = [None] * n  # keeps slot shape for EOF bubbles
    delay = getattr(filt, "delay", 0)

    def gather():
        """The next tick's (frames, timestamps, live flags), one slot per
        stream, or None once every stream has ended or the pipeline stops."""
        idle = None if window is None else lambda: window.poll(fanout)
        while not stop_event.is_set() and not all(eof):
            raws, tss, lives = [], [], []
            for i in range(n):
                stalled = False
                if eof[i]:
                    item = None
                else:  # a stream's first frame is always waited for
                    timeout = None if last_frame[i] is None else slow_stream_timeout
                    try:
                        item = io.get(i, timeout=timeout, idle=idle)
                    except queue.Empty:
                        item, stalled = None, True
                if stalled:
                    # Slow (not ended) stream: bubble THIS batch only.
                    stats.stalls += 1
                    raws.append(last_frame[i])
                    tss.append(0.0)
                    lives.append(False)
                elif item is None:
                    if stop_event.is_set():
                        return None  # a thread failed: its reader sends no EOF
                    eof[i] = True
                    if last_frame[i] is None:
                        raise RuntimeError(f"stream {i} produced no frames")
                    raws.append(last_frame[i])  # bubble (dropped via valid)
                    tss.append(0.0)
                    lives.append(False)
                else:
                    raw_np, ts = item
                    last_frame[i] = raw_np
                    raws.append(raw_np)
                    tss.append(ts)
                    lives.append(True)
                    stats.frames_in += 1
            if all(eof) and not any(lives):
                return None
            # A pure stall tick (no live frame and nothing left to drain)
            # would run a batch where every slot's state is frozen and every
            # output invalid: skip it.
            if not any(lives) and not any(eof[i] and drained[i] <= delay for i in range(n)):
                continue
            return raws, tss, lives
        return None

    sinks = [None if on_output is None else functools.partial(on_output, i) for i in range(n)]
    with pipeline.Threads(sess, readers, sinks, stop_event, queue_depth, max_frames) as io:
        with trace_scope("loop"):
            while True:
                # A tick's span: its wait for a frame of every stream, then
                # its work.
                tick_span = trace_scope("tick", stats.batches)
                with tick_span:
                    with trace_scope("read_wait"):
                        batch = gather()
                    if batch is None:
                        tick_span.discard()
                        break
                    raws, tss, lives = batch
                    for i in range(n):
                        if eof[i]:
                            drained[i] += 1
                    if states is None:
                        states = multi.init(pipeline.frame_spec(raws[0], work_format), device=device)
                        window = pipeline.Window([((n, *raws[0].shape), torch.uint8), ((n, 3), torch.float32)],
                                                 device, inflight)
                    run(raws, tss, lives, eof)
            # Flush: run `delay` bubble batches so frames still inside delay
            # queues emit (the reference's stream() drops them at termination,
            # VideoFilter.cpp:170-200; a serving runtime must not lose frames).
            if flush and states is not None and not stop_event.is_set():
                bubble = [np.zeros_like(last_frame[0])] * n
                for _ in range(delay):
                    with trace_scope("tick", stats.batches):
                        run(bubble, [0.0] * n, [False] * n, [True] * n)
        if window is not None:
            window.drain(fanout)
    stats.graphs = compiled.n_graphs if compiled is not None else 0
