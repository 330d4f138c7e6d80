"""Streaming pipeline: decode -> device step -> encode, fully overlapped
(counterpart of livevisionkit_tpu/runtime/stream.py).

Reference parity: ``VideoFilter::stream`` (reference Filters/VideoFilter
.cpp:62-209) — a 3-thread pipeline (reader / filter / output threads, two
15-deep bounded queues with backpressure, early-termination draining) —
and the CLI driver ``VideoProcessor::run`` (reference
Modules/VideoEditor/VideoProcessor.cpp:148-230).

On a CUDA device the filter loop never waits inside a step:

  * a reader thread keeps a bounded queue of decoded host frames (the
    reference's 15-frame input queue);
  * the main loop copies each frame into a ring of `inflight + 1` pinned
    host buffers, uploads it with a non-blocking copy, repacks it on the
    device (u8 HWC -> planar float) and runs the step without a host sync;
  * the output's pixels, timestamp and valid flag come back together by a
    non-blocking copy into pinned memory behind one CUDA event
    (runtime/transfer.py, shared with the multi-stream driver);
  * `drain` waits on the oldest pending event only once more than
    `inflight` outputs are pending: that wait is the backpressure;
  * a writer thread encodes drained frames (the reference's output thread).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import CompositeFilter, FrameSpec, VideoFilter
from livevisionkit_tpu_torch.runtime.hud import draw_frame_time_hud
from livevisionkit_tpu_torch.runtime.transfer import Uploader, download
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.profiling import Stopwatch, frame_scope, trace_scope


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    frame_time: Stopwatch = field(default_factory=Stopwatch)
    # Per-filter device-synced timings, only in profile mode (reference
    # VideoProcessor -v, VideoProcessor.cpp:291-356).
    filter_times: dict = field(default_factory=dict)
    # Per-output submit -> drain latency samples (seconds): from the end of
    # the frame's submission to its pixels being host-resident, i.e. the
    # live pipeline latency INCLUDING the deliberate in-flight window.  The
    # stabilizer's algorithmic delay (its delay queue) is not included.
    latencies: list = field(default_factory=list)

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


def _ingest(bgr_hwc_u8: torch.Tensor) -> torch.Tensor:
    """On-device repack: HWC u8 BGR -> (3, H, W) float32 [0, 1]."""
    return (bgr_hwc_u8.to(torch.float32) * (1.0 / 255.0)).permute(2, 0, 1)


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
) -> StreamStats:
    """Run `filt` over `reader` (yields (bgr_hwc_uint8, timestamp)) on
    `device`.

    on_output receives (planar_float_bgr (3,H,W), timestamp) for every VALID
    output frame, in order, from the writer thread.  Conversion into/out of
    `work_format` happens on the device around the filter, mirroring the
    reference's YUV inter-filter convention (Filters/VideoFilter.hpp:31).

    profile_filters steps each element of a CompositeFilter on its own and
    waits for the device after each, timing it under "i:name" in
    `filter_times` (the reference's sync-to-measure, Stopwatch.cpp:127-131);
    it costs the pipelining.  hud_budget_ms enables the reference's
    test-mode frame-time HUD (VSFilter.cpp:368-383): the host-measured
    frame time is stamped onto every output, green within budget / red over
    (runtime/hud.py).
    """
    device = torch.device(device)
    stats = StreamStats()
    stop_event = stop_event or threading.Event()

    in_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    reader_exc: list[BaseException] = []

    def _put_with_stop(item) -> bool:
        """Bounded put that aborts when the pipeline stops (a plain blocking
        put would strand the reader on a full queue after an abort)."""
        while not stop_event.is_set():
            try:
                in_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def read_loop():
        n = 0
        try:
            for frame, ts in reader:
                if stop_event.is_set():
                    break
                if not _put_with_stop((frame, ts)):
                    return
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        except BaseException as e:  # surface decode errors like encode ones
            reader_exc.append(e)
            stop_event.set()
        _put_with_stop(None)  # EOF

    reader_thread = threading.Thread(target=read_loop, daemon=True)
    reader_thread.start()

    out_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    writer_exc: list[BaseException] = []

    def write_loop():
        while True:
            item = out_q.get()
            if item is None:
                return
            try:
                if on_output is not None:
                    on_output(*item)
            except BaseException as e:  # surface encode errors to caller
                writer_exc.append(e)
                stop_event.set()
                return

    writer_thread = threading.Thread(target=write_loop, daemon=True)
    writer_thread.start()

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
        for k in sub_keys:
            stats.filter_times[k] = Stopwatch()

    state = None
    upload = None
    pending: deque = deque()  # ((pixels, ts, valid) on the host, event, t_submit)

    def drain(block_all: bool):
        while pending and (block_all or len(pending) > inflight):
            (px, ts, valid), event, t_sub = pending.popleft()
            if event is not None:
                event.synchronize()  # backpressure: the oldest output only
            if not bool(valid):
                continue
            out_np = px.numpy()
            stats.latencies.append(time.perf_counter() - t_sub)
            if hud_budget_ms is not None:
                out_np = draw_frame_time_hud(
                    np.array(out_np), stats.frame_time.last() * 1e3, hud_budget_ms,
                )
            stats.frames_out += 1
            # Stop-aware put: a dead writer leaves the queue full and a
            # blocking put would hang the pipeline on abort.
            while not stop_event.is_set():
                try:
                    out_q.put((out_np, float(ts)), timeout=0.1)
                    break
                except queue.Full:
                    continue

    try:
        while not stop_event.is_set():
            # Poll, don't block: after an abort the reader stops feeding
            # without an EOF sentinel (its puts bail on stop_event), so a
            # blocking get would hang here forever.
            try:
                item = in_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            raw_np, ts = item
            if state is None:
                spec = FrameSpec(
                    height=raw_np.shape[0],
                    width=raw_np.shape[1],
                    channels=work_format.channels,
                    format=work_format,
                )
                state = filt.init(spec, device=device)
                upload = Uploader([(raw_np.shape, torch.uint8), ((1,), torch.float32)], device,
                                  inflight + 1)
            stats.frame_time.tick()
            # frame_scope/trace_scope: profiler spans (reference LVK_PROFILE,
            # ScopedProfiler.cpp:26-37), next to free unless a trace is
            # active (the CLI's --trace).
            with frame_scope(stats.frames_in):
                with trace_scope("upload"):
                    raw_h, ts_h = upload.host()
                    raw_h[...] = raw_np
                    ts_h[0] = ts
                    raw, meta = upload.send()
                    frame = Frame(pixels=_ingest(raw), timestamp=meta[0], valid=live,
                                  format=bgr).reformat(work_format)
                if sub_filters is None:
                    with trace_scope("step"):
                        state, frame = filt.step(state, frame)
                else:
                    wait()  # the first filter's time is its own
                    new_states = []
                    for k, sub, sub_state in zip(sub_keys, sub_filters, state):
                        watch = stats.filter_times[k]
                        watch.start()
                        with trace_scope(k):
                            sub_state, frame = sub.step(sub_state, frame)
                            wait()
                        watch.stop()
                        new_states.append(sub_state)
                    state = tuple(new_states)
                with trace_scope("download"):
                    out = frame.reformat(bgr)
                    host, event = download((out.pixels, out.timestamp, out.valid))
            pending.append((host, event, time.perf_counter()))
            stats.frames_in += 1
            drain(block_all=False)
        drain(block_all=True)
    finally:
        stop_event.set()
        # Deliver the writer's EOF sentinel without deadlocking: the writer
        # may still be draining (keep trying) or already dead (give up).
        for _ in range(300):
            try:
                out_q.put(None, timeout=0.1)
                break
            except queue.Full:
                if not writer_thread.is_alive():
                    break
        writer_thread.join(timeout=30)
        reader_thread.join(timeout=5)
    if writer_exc:
        raise writer_exc[0]
    if reader_exc:
        raise reader_exc[0]
    return stats
