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
    without waiting for the device;
  * a stream that ended keeps its slot with valid=False bubbles flagged
    drain=True, so its delay-queue residue emits while the others run; a
    stream that is merely slow gets drain=False bubbles, which FREEZE its
    temporal state (no frame is lost);
  * a small in-flight window bounds how far the device runs ahead; the
    driver waits on the oldest pending output, never inside the step, and
    fans results out to per-stream writer threads.

On a CUDA device a batch goes up from a ring of `inflight + 1` pinned host
buffers with a non-blocking copy, and a buffer is refilled only after the
event recorded behind its copy has passed; outputs come back the same way
into pinned memory.  The per-tick timestamps and flags ride in the same
upload, so the loop makes no synchronizing copy.
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
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.profiling import Stopwatch


@dataclass
class MultiStreamStats:
    frames_in: int = 0  # total decoded frames across streams
    frames_out: int = 0  # total valid emitted frames
    batches: int = 0
    stalls: int = 0  # bubbles injected for slow (not ended) streams
    batch_time: Stopwatch = field(default_factory=Stopwatch)
    per_stream_out: list = field(default_factory=list)

    @property
    def fps_aggregate(self) -> float:
        avg = self.batch_time.average()
        if avg <= 0 or self.batches == 0:
            return 0.0
        return (self.frames_out / self.batches) / avg


class _Uploader:
    """Host batches to the device: (S, H, W, 3) u8 frames and an (S, 3) f32
    block of (timestamp, live, drain) per tick.  On a CUDA device they are
    staged in a ring of pinned buffers and copied without blocking; a slot
    is refilled only after the event behind its last copy has passed."""

    def __init__(self, frame_shape: tuple, n_streams: int, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.frames = [torch.empty((n_streams, *frame_shape), dtype=torch.uint8, pin_memory=self.cuda)
                       for _ in range(slots)]
        self.meta = [torch.empty((n_streams, 3), dtype=torch.float32, pin_memory=self.cuda)
                     for _ in range(slots)]
        self.events: list = [None] * slots
        self.slot = 0

    def __call__(self, raws: Sequence[np.ndarray], tss, lives, drains):
        k = self.slot
        self.slot = (k + 1) % len(self.frames)
        if self.events[k] is not None:
            self.events[k].synchronize()
        np.stack(raws, out=self.frames[k].numpy())
        self.meta[k].numpy()[:] = np.stack([tss, lives, drains], axis=1)
        if not self.cuda:
            frames, meta = self.frames[k].clone(), self.meta[k].clone()
        else:
            frames = self.frames[k].to(self.device, non_blocking=True)
            meta = self.meta[k].to(self.device, non_blocking=True)
            self.events[k] = torch.cuda.Event()
            self.events[k].record()
        return frames, meta[:, 0], meta[:, 1] > 0.5, meta[:, 2] > 0.5


def _download(out: tuple[torch.Tensor, ...]):
    """Start copying a tick's outputs to the host; return the host tensors
    and an event to wait on (None on the CPU)."""
    if out[0].device.type != "cuda":
        return out, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
    for h, t in zip(host, out):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


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
        x = raw_u8.to(torch.float32).permute(2, 0, 1) * (1.0 / 255.0)
        frame = Frame(pixels=x, timestamp=ts, valid=live, format=bgr).reformat(work_format)
        state, out = filt.step(state, frame, drain=drain)
        out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    # `drain` is a per-stream flag: an EOF'd slot DRAINS its delay queue
    # (bubbles advance it with identity motion, emitting the residue while
    # other streams still run), a merely stalled slot FREEZES it (no frame
    # loss; see VideoFilter.step).  The terminal flush drains all.
    step = batched(one_step)

    states = None
    upload = None
    pending: deque = deque()

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
                upload = _Uploader(raws[0].shape, n, device, inflight + 1)
            stats.batch_time.tick()
            states, out = step(states, *upload(raws, tss, lives, eof))
            stats.batches += 1
            pending.append(_download(out))
            drain(block_all=False)
        # Flush: run `delay` bubble batches so frames still inside delay
        # queues emit (the reference's stream() drops them at termination,
        # VideoFilter.cpp:170-200; a serving runtime must not lose frames).
        if flush and states is not None and not stop_event.is_set():
            bubble = [np.zeros_like(last_frame[0])] * n
            for _ in range(delay):
                states, out = step(states, *upload(bubble, [0.0] * n, [False] * n, [True] * n))
                stats.batches += 1
                pending.append(_download(out))
                drain(block_all=False)
        drain(block_all=True)
    finally:
        stop_event.set()
        for q_ in out_qs:
            q_.put(None)
        for w in writers:
            w.join(timeout=30)
    if writer_exc:
        raise writer_exc[0]
    return stats
