"""The live pipeline under both drivers, `stream()` (runtime/stream.py) and
`stream_multi()` (runtime/multistream.py): decode -> device step -> encode,
fully overlapped.  On a CUDA device the driver's loop never waits inside a
step:

  * a reader thread a source keeps a bounded queue of decoded host frames
    (the reference's 15-frame input queue, Filters/VideoFilter.cpp:62-209);
  * the loop copies each frame (or tick) into a ring of `inflight + 1`
    pinned host buffers and uploads it with a non-blocking copy into the
    step's static inputs; the step (`device_step`: repack, convert to the
    work format, the filter's step, convert back) is one CUDA graph;
  * the outputs come back by a non-blocking copy into pinned memory behind
    one CUDA event, on the stream that replays the graph, so the next
    replay, which overwrites the graph's outputs, is ordered after the copy;
  * each output is handed over, oldest first, as soon as its copy has
    completed: at each push, and while the loop waits for its next input,
    which it then polls every `IDLE_POLL_S` and ends as soon as an input
    arrives.  The window waits on the oldest pending event only once more
    than `inflight` outputs are pending: that wait is the backpressure
    alone (a ring slot's reuse waits on the slot's own event, `Window.host`);
  * a writer thread a sink encodes handed-over frames (the reference's
    output thread).

Every put and every get watches one stop event, so a
thread that fails stops the pipeline without stranding another, and its
error is raised when the pipeline closes.  On the CPU the copies are plain
and there is no event.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.ops.color import from_u8
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils import profiling
from livevisionkit_tpu_torch.utils.profiling import Session, trace_scope

# How often a loop waiting for its next input, with outputs pending, asks
# whether the oldest one's copy has completed (s).
IDLE_POLL_S = 0.0002


def ingest(bgr_hwc_u8: torch.Tensor) -> torch.Tensor:
    """On-device repack: HWC u8 BGR -> (3, H, W) float32 [0, 1]."""
    return from_u8(bgr_hwc_u8).permute(2, 0, 1)


def frame_spec(raw_hwc: np.ndarray, work_format: PixelFormat) -> FrameSpec:
    """The spec of the frames `device_step` hands the filter, from a raw frame."""
    return FrameSpec(height=raw_hwc.shape[0], width=raw_hwc.shape[1], channels=work_format.channels,
                     format=work_format)


def device_step(filt: VideoFilter, work_format: PixelFormat) -> Callable:
    """`filt`'s step from and to BGR u8 frames: (state, raw HWC u8, timestamp,
    live flag, drain flag) -> (state, (pixels, timestamp, valid)), the frame
    converted into `work_format` around the filter (the reference's YUV
    inter-filter convention, Filters/VideoFilter.hpp:31) and the output back
    into planar float BGR."""
    bgr = PixelFormat.BGR

    def step(state, raw_u8, ts, live, drain):
        with trace_scope("ingest"):
            frame = Frame(pixels=ingest(raw_u8), timestamp=ts, valid=live, format=bgr).reformat(work_format)
        state, out = filt.step(state, frame, drain=drain)
        with trace_scope("egress"):
            out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    return step


class Threads:
    """A reader thread for each of `sources` (iterables of (frame,
    timestamp)) filling its queue `in_qs[i]`, then an EOF (None), and a
    writer thread for each of `sinks` (callables, or None to drop) emptying
    `out_qs[i]` up to an EOF.  A context manager: its exit stops the
    pipeline and, unless the block raised, raises a writer's error, else a
    reader's."""

    def __init__(self, sess: Session, sources: Sequence, sinks: Sequence[Callable | None],
                 stop_event: threading.Event, queue_depth: int, max_frames: int | None):
        self.stop = stop_event
        self.in_qs = [queue.Queue(maxsize=queue_depth) for _ in sources]
        self.out_qs = [queue.Queue(maxsize=queue_depth) for _ in sinks]
        self.reader_errors: list[BaseException] = []
        self.writer_errors: list[BaseException] = []
        self.readers = [threading.Thread(target=self._read, args=(sess, src, q, max_frames), daemon=True)
                        for src, q in zip(sources, self.in_qs)]
        self.writers = [threading.Thread(target=self._write, args=(sess, sink, q), daemon=True)
                        for sink, q in zip(sinks, self.out_qs)]
        for thread in self.readers + self.writers:
            thread.start()

    def put(self, q: queue.Queue, item) -> bool:
        """Bounded put that gives up once the pipeline stops (a plain
        blocking put would strand its thread on a full queue whose consumer
        is gone)."""
        while not self.stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self, i: int, timeout: float | None = None, idle: Callable[[], bool] | None = None):
        """Source i's next (frame, timestamp), None at its end or once the
        pipeline stops; with `timeout`, `queue.Empty` after that many seconds
        without one.  Polls, doesn't block: after an abort a reader stops
        feeding without an EOF (its puts give up), so a blocking get would
        hang.  While `idle` (a window's `poll`) reports outputs pending, the
        polls are `IDLE_POLL_S` apart and `idle` runs between them, so an
        output is handed over once its copy completes and an input that
        arrives still ends the wait at once."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        pending = idle is not None
        while not self.stop.is_set():
            wait = IDLE_POLL_S if pending else 0.1
            if deadline is not None:
                wait = min(wait, deadline - time.perf_counter())
                if wait <= 0:
                    raise queue.Empty
            try:
                return self.in_qs[i].get(timeout=wait)
            except queue.Empty:
                pending = pending and idle()
        return None

    def _read(self, sess: Session, source, q: queue.Queue, max_frames: int | None) -> None:
        n = 0
        try:
            with sess.active():
                frames = iter(source)
                while True:
                    with trace_scope("read"):
                        item = next(frames, None)
                    if item is None or self.stop.is_set():
                        break
                    frame, ts = item
                    if not self.put(q, (frame, ts)):
                        return
                    n += 1
                    if max_frames is not None and n >= max_frames:
                        break
        except BaseException as e:  # surface decode errors like encode ones
            self.reader_errors.append(e)
            self.stop.set()
        self.put(q, None)  # EOF

    def _write(self, sess: Session, sink: Callable | None, q: queue.Queue) -> None:
        with sess.active():
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    if sink is not None:
                        with trace_scope("write"):
                            sink(*item)
                except BaseException as e:  # surface encode errors to the caller
                    self.writer_errors.append(e)
                    self.stop.set()
                    return

    def __enter__(self) -> "Threads":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop.set()
        # Deliver each writer's EOF without deadlocking: a writer may still
        # be draining (keep trying) or already dead (give up).
        for q, writer in zip(self.out_qs, self.writers):
            for _ in range(300):
                try:
                    q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    if not writer.is_alive():
                        break
        for thread in self.writers:
            thread.join(timeout=30)
        for thread in self.readers:
            thread.join(timeout=5)
        if exc_type is None:
            for errors in (self.writer_errors, self.reader_errors):
                if errors:
                    raise errors[0]
        return False


class Window:
    """The in-flight window of a driver's step on `device`: the upload ring
    of `inflight + 1` slots, each a host buffer per (shape, dtype) of
    `shapes`, the downloads, and the outputs pending on the host."""

    def __init__(self, shapes: Sequence[tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device | str, inflight: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.inflight = inflight
        self.buffers = [[torch.empty(tuple(shape), dtype=dtype, pin_memory=self.cuda)
                         for shape, dtype in shapes] for _ in range(inflight + 1)]
        self.events: list = [None] * (inflight + 1)
        self.slot = 0
        self.pending: deque = deque()  # (host outputs, event, submit time)

    def host(self) -> list[np.ndarray]:
        """The next slot's buffers as numpy arrays to fill in place, once
        the copy last made from them has passed."""
        k = self.slot
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return [b.numpy() for b in self.buffers[k]]

    def send(self, out: Sequence[torch.Tensor] | None = None) -> list[torch.Tensor]:
        """Copy the slot filled since `host()` to the device, into `out`
        when given (a compiled step's static inputs), and move on."""
        k = self.slot
        self.slot = (k + 1) % len(self.buffers)
        if out is None:
            out = [b.to(self.device, non_blocking=True) if self.cuda else b.clone()
                   for b in self.buffers[k]]
        else:
            out = list(out)
            for dst, b in zip(out, self.buffers[k]):
                dst.copy_(b, non_blocking=self.cuda)
        if self.cuda:
            self.events[k] = torch.cuda.Event()
            self.events[k].record(torch.cuda.current_stream(self.device))
        return out

    def push(self, out: Sequence[torch.Tensor], deliver: Callable) -> None:
        """Start copying the step's outputs to the host (the `download`
        span), keep them pending, stamped with the time they were submitted,
        hand over those whose copies have completed, and wait down to
        `inflight` pending."""
        with trace_scope("download"):
            if out[0].device.type != "cuda":
                host, event = tuple(t.clone() for t in out), None
            else:
                host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
                for h, t in zip(host, out):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(out[0].device))
        self.pending.append((host, event, time.perf_counter()))
        self.poll(deliver)
        self.drain(deliver, keep=self.inflight)

    def poll(self, deliver: Callable) -> bool:
        """Hand pending outputs, oldest first, to `deliver(host outputs,
        submit time)` while the oldest one's copy has completed (on the CPU
        at once), so a later copy that completes first still waits its turn;
        whether any output is still pending.  Counts `window.early`, the
        outputs handed over while no more than `inflight` were pending,
        which the wait of `drain` would have held."""
        while self.pending:
            event = self.pending[0][1]
            if event is not None and not event.query():
                return True
            if len(self.pending) <= self.inflight:
                profiling.count("window.early")
            self._hand(deliver)
        return False

    def drain(self, deliver: Callable, keep: int = 0) -> None:
        """Hand pending outputs, oldest first, to `deliver` while more than
        `keep` are pending, each once its copy has completed (`drain_wait`)."""
        while len(self.pending) > keep:
            event = self.pending[0][1]
            if event is not None:
                with trace_scope("drain_wait"):
                    event.synchronize()
            self._hand(deliver)

    def _hand(self, deliver: Callable) -> None:
        """Hand the oldest pending output over (counter `window.outputs`)."""
        host, _, t_submit = self.pending.popleft()
        profiling.count("window.outputs")
        deliver(host, t_submit)
