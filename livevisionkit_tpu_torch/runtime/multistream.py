"""Multi-stream end-to-end driver: S decoders -> one batched step per frame
tick -> S encoders (counterpart of livevisionkit_tpu/runtime/multistream.py).

The reference runs one ``VideoFilter::stream`` pipeline per filter
instance (Filters/VideoFilter.cpp:62-209); serving S videos there means S
processes with no shared batching.  Here the S streams batch into ONE step
per tick (parallel/streams.py): the step's launches, the warp's and LK's
included, are paid once per tick for all S streams.

Design, as in the JAX package:
  * one reader thread per stream feeding a bounded queue (the reference's
    15-deep input queue, per stream);
  * the main loop assembles a LOCKSTEP BATCH, one frame per live stream,
    uploads it as one (S, H, W, 3) u8 tensor and runs the batched step
    without waiting for the device: on the card one CUDA graph a tick
    (utils/compiled.jit_step), as the JAX runtime dispatches one compiled
    program a tick;
  * a stream that ended keeps its slot with valid=False bubbles flagged
    drain=True, so its delay-queue residue emits while the others run; a
    stream that is merely slow gets drain=False bubbles, which FREEZE its
    temporal state (no frame is lost);
  * a small in-flight window bounds how far the device runs ahead; the
    driver waits on the oldest pending output, never inside the step, and
    fans results out to per-stream writer threads.

On a CUDA device a batch goes up from a ring of `inflight + 1` pinned host
buffers with a non-blocking copy into the graph's static inputs, and
outputs come back the same way into pinned memory (runtime/transfer.py,
shared with the solo driver), on the stream that replays the graph.  The
per-tick timestamps and flags ride in the same upload, so the loop makes
no synchronizing copy, and `drain` is a per-stream device flag: one graph
serves live, stalled and draining ticks.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter, batched
from livevisionkit_tpu_torch.runtime.stream import _ingest
from livevisionkit_tpu_torch.runtime.transfer import Uploader, download
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.compiled import jit_step
from livevisionkit_tpu_torch.utils.profiling import Stopwatch


@dataclass
class MultiStreamStats:
    frames_in: int = 0  # total decoded frames across streams
    frames_out: int = 0  # total valid emitted frames
    batches: int = 0
    stalls: int = 0  # bubbles injected for slow (not ended) streams
    batch_time: Stopwatch = field(default_factory=Stopwatch)
    per_stream_out: list = field(default_factory=list)
    graphs: int = 0  # CUDA graphs captured (0 op by op and on the CPU)

    @property
    def fps_aggregate(self) -> float:
        avg = self.batch_time.average()
        if avg <= 0 or self.batches == 0:
            return 0.0
        return (self.frames_out / self.batches) / avg


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
    """
    n = len(readers)
    device = torch.device(device)
    stats = MultiStreamStats(per_stream_out=[0] * n)
    stop_event = stop_event or threading.Event()
    multi = MultiStreamFilter(filt, n)

    in_qs = [queue.Queue(maxsize=queue_depth) for _ in range(n)]

    def read_loop(i, reader):
        count = 0
        for frame, ts in reader:
            if stop_event.is_set():
                break
            in_qs[i].put((frame, ts))
            count += 1
            if max_frames is not None and count >= max_frames:
                break
        in_qs[i].put(None)  # EOF

    for i, r in enumerate(readers):
        threading.Thread(target=read_loop, args=(i, r), daemon=True).start()

    out_qs = [queue.Queue(maxsize=queue_depth) for _ in range(n)]
    writer_exc: list[BaseException] = []

    def write_loop(i):
        while True:
            item = out_qs[i].get()
            if item is None:
                return
            try:
                if on_output is not None:
                    on_output(i, *item)
            except BaseException as e:  # re-raised by the driver below
                writer_exc.append(e)
                stop_event.set()
                return

    writers = [threading.Thread(target=write_loop, args=(i,), daemon=True) for i in range(n)]
    for w in writers:
        w.start()

    bgr = PixelFormat.BGR

    def one_step(state, raw_u8, ts, live, drain):
        frame = Frame(pixels=_ingest(raw_u8), timestamp=ts, valid=live, format=bgr).reformat(work_format)
        state, out = filt.step(state, frame, drain=drain)
        out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    # `drain` is a per-stream flag: an EOF'd slot DRAINS its delay queue
    # (bubbles advance it with identity motion, emitting the residue while
    # other streams still run), a merely stalled slot FREEZES it (no frame
    # loss; see VideoFilter.step).  The terminal flush drains all.
    batch_step = batched(one_step)

    def tick(state, raw_u8, meta):
        """One tick from the upload: (S, H, W, 3) u8 frames and the (S, 3)
        f32 block of (timestamp, live, drain)."""
        return batch_step(state, raw_u8, meta[:, 0], meta[:, 1] > 0.5, meta[:, 2] > 0.5)

    compiled = jit_step(tick) if jit else None
    step = compiled or tick

    states = None
    upload = None
    inputs = None  # the compiled step's static (frames, meta), once captured
    pending: deque = deque()

    def run(raws, tss, lives, drains):
        """Upload one tick and step it."""
        nonlocal states, inputs
        frames, meta = upload.host()
        np.stack(raws, out=frames)
        meta[:] = np.stack([tss, lives, drains], axis=1)
        frames, meta = upload.send(inputs)
        states, out = step(states, frames, meta)
        if compiled is not None and inputs is None:
            inputs = compiled.static_inputs(states, frames, meta)
        stats.batches += 1
        pending.append(download(out))
        drain(block_all=False)

    def drain(block_all: bool):
        while pending and (block_all or len(pending) > inflight):
            (px, ts, valid), event = pending.popleft()
            if event is not None:
                event.synchronize()  # backpressure: the oldest batch only
            valid_np = valid.numpy()
            if not valid_np.any():
                continue
            px_np, ts_np = px.numpy(), ts.numpy()
            for i in range(n):
                if valid_np[i]:
                    stats.frames_out += 1
                    stats.per_stream_out[i] += 1
                    out_qs[i].put((px_np[i], float(ts_np[i])))

    eof = [False] * n
    drained = [0] * n  # batches dispatched since stream i's EOF
    last_frame = [None] * n  # keeps slot shape for EOF bubbles
    delay = getattr(filt, "delay", 0)
    try:
        while not stop_event.is_set() and not all(eof):
            raws, tss, lives = [], [], []
            for i in range(n):
                stalled = False
                if eof[i]:
                    item = None
                elif slow_stream_timeout is None or last_frame[i] is None:
                    item = in_qs[i].get()
                else:
                    try:
                        item = in_qs[i].get(timeout=slow_stream_timeout)
                    except queue.Empty:
                        item, stalled = None, True
                if stalled:
                    # Slow (not ended) stream: bubble THIS batch only.
                    stats.stalls += 1
                    raws.append(last_frame[i])
                    tss.append(0.0)
                    lives.append(False)
                elif item is None:
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
                break
            # A pure stall tick (no live frame and nothing left to drain)
            # would run a batch where every slot's state is frozen and every
            # output invalid: skip it.
            if not any(lives) and not any(eof[i] and drained[i] <= delay for i in range(n)):
                continue
            for i in range(n):
                if eof[i]:
                    drained[i] += 1
            if states is None:
                h, w = raws[0].shape[:2]
                spec = FrameSpec(height=h, width=w, channels=work_format.channels,
                                 format=work_format)
                states = multi.init(spec, device=device)
                upload = Uploader([((n, *raws[0].shape), torch.uint8), ((n, 3), torch.float32)],
                                  device, inflight + 1)
            stats.batch_time.tick()
            run(raws, tss, lives, eof)
        # Flush: run `delay` bubble batches so frames still inside delay
        # queues emit (the reference's stream() drops them at termination,
        # VideoFilter.cpp:170-200; a serving runtime must not lose frames).
        if flush and states is not None and not stop_event.is_set():
            bubble = [np.zeros_like(last_frame[0])] * n
            for _ in range(delay):
                run(bubble, [0.0] * n, [False] * n, [True] * n)
        drain(block_all=True)
    finally:
        stop_event.set()
        for q_ in out_qs:
            q_.put(None)
        for w in writers:
            w.join(timeout=30)
    if writer_exc:
        raise writer_exc[0]
    stats.graphs = compiled.n_graphs if compiled is not None else 0
    return stats
