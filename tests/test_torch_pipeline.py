"""The in-flight window's hand-over rule (`runtime/pipeline.Window`): each
output is handed over, oldest first, as soon as its copy has completed, at a
push and while the loop waits for its next input; the wait on the oldest
output engages only beyond `inflight` pending; the counters
`window.outputs` and `window.early`.  Stub events stand in for CUDA events,
so the CPU tests choose when each copy completes.

The `cuda` test needs a card and skips without one.  This file imports
torch only, so on a machine without JAX it runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline.py
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from livevisionkit_tpu_torch.filters.base import CompositeFilter, IdentityFilter
from livevisionkit_tpu_torch.parallel import dryrun
from livevisionkit_tpu_torch.runtime import pipeline
from livevisionkit_tpu_torch.runtime.multistream import stream_multi
from livevisionkit_tpu_torch.runtime.stream import stream
from livevisionkit_tpu_torch.utils import profiling


class StubEvent:
    """A CUDA event's `query` and `synchronize`, completed by the test."""

    def __init__(self, done: bool = False):
        self.done = done
        self.waits = 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waits += 1
        self.done = True


def _window(inflight, events):
    """A CPU window holding one pending output per event, output k's host
    tensor holding k."""
    win = pipeline.Window([((2,), torch.uint8)], "cpu", inflight)
    for k, event in enumerate(events):
        win.pending.append(((torch.tensor([k]),), event, 0.0))
    return win


def _collector():
    got = []
    return got, lambda host, t_submit: got.append(int(host[0][0]))


def test_poll_hands_over_completed_outputs_at_once_in_order():
    events = [StubEvent() for _ in range(3)]
    win = _window(3, events)
    got, deliver = _collector()
    events[0].done = events[1].done = True
    assert win.poll(deliver) is True
    assert got == [0, 1]
    events[2].done = True
    assert win.poll(deliver) is False
    assert got == [0, 1, 2] and not win.pending
    assert sum(e.waits for e in events) == 0


def test_an_incomplete_older_output_holds_back_a_completed_newer_one():
    events = [StubEvent(), StubEvent(done=True), StubEvent(done=True)]
    win = _window(3, events)
    got, deliver = _collector()
    assert win.poll(deliver) is True
    assert got == [] and len(win.pending) == 3
    events[0].done = True
    assert win.poll(deliver) is False
    assert got == [0, 1, 2]


def test_push_waits_on_the_oldest_only_beyond_inflight():
    """A push hands over what has completed, then waits (`drain_wait`) on
    the oldest output only while more than `inflight` are pending."""
    events = [StubEvent(), StubEvent()]
    win = _window(2, events)
    got, deliver = _collector()
    with profiling.session("stream") as sess:
        win.push((torch.tensor([2]),), deliver)  # a CPU output: its copy is done
    assert got == [0] and events[0].waits == 1 and events[1].waits == 0
    assert len(win.pending) == 2
    assert sess.spans["drain_wait"].n == 1
    assert sess.counters == {"window.outputs": 1}


def test_push_hands_over_completed_outputs_before_any_wait():
    events = [StubEvent(done=True), StubEvent(done=True)]
    win = _window(2, events)
    got, deliver = _collector()
    with profiling.session("stream") as sess:
        win.push((torch.tensor([2]),), deliver)
    assert got == [0, 1, 2] and not win.pending
    assert sum(e.waits for e in events) == 0
    assert "drain_wait" not in sess.spans


def test_window_counters_count_outputs_and_early_ones():
    """`window.outputs` counts every output handed over; `window.early`
    those handed over while no more than `inflight` were pending, which the
    wait beyond `inflight` would have held."""
    events = [StubEvent(done=True), StubEvent()]
    win = _window(2, events)
    got, deliver = _collector()
    with profiling.session("stream") as sess:
        # Three pending: 0 goes (not early: more than inflight pending), 1
        # holds 2 back, two pending is within inflight, so no wait.
        win.push((torch.tensor([2]),), deliver)
        assert got == [0] and events[1].waits == 0
        events[1].done = True
        assert win.poll(deliver) is False  # 1 and 2, both early
        win.pending.append(((torch.tensor([3]),), StubEvent(), 0.0))
        win.drain(deliver)  # the end: a wait, not early
    assert got == [0, 1, 2, 3]
    assert sess.counters == {"window.outputs": 4, "window.early": 2}


class _GatedSource:
    """A source whose one frame is released by `release()`."""

    def __init__(self):
        self.gate = threading.Event()

    def __iter__(self):
        if self.gate.wait(timeout=30):
            yield np.zeros((2, 2, 3), np.uint8), 0.0

    def release(self):
        self.gate.set()


def _threads(source):
    sess = profiling.Session("stream")
    return pipeline.Threads(sess, [source], [None], threading.Event(), queue_depth=2, max_frames=None)


def _in_thread(fn, seconds=30.0):
    """fn() run in a thread with a join timeout: its result or error."""
    box = {}

    def body():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the test's thread
            box["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(timeout=seconds)
    assert not th.is_alive(), "the wait did not end"
    if "error" in box:
        raise box["error"]
    return box["value"]


def test_the_wait_for_input_hands_over_an_output_that_completes():
    """An output whose copy completes while no input waits is handed over
    inside the wait; the input, released only once it has been, then ends
    the wait."""
    event = StubEvent()
    win = _window(3, [event])
    src = _GatedSource()
    got = []

    def deliver(host, t_submit):
        got.append(int(host[0][0]))
        src.release()

    with _threads(src) as io:
        threading.Timer(0.05, lambda: setattr(event, "done", True)).start()
        item = _in_thread(lambda: io.get(0, idle=lambda: win.poll(deliver)))
    assert item is not None and item[1] == 0.0
    assert got == [0] and event.waits == 0


def test_the_wait_for_input_ends_when_an_input_arrives_with_outputs_pending():
    """An input ends the wait at once though the pending output's copy never
    completes: the wait never blocks on a copy."""
    event = StubEvent()
    win = _window(3, [event])
    src = _GatedSource()
    got, deliver = _collector()
    with _threads(src) as io:
        threading.Timer(0.05, src.release).start()
        item = _in_thread(lambda: io.get(0, idle=lambda: win.poll(deliver)))
    assert item is not None
    assert got == [] and len(win.pending) == 1 and event.waits == 0


def test_a_timed_wait_for_input_hands_over_outputs_then_times_out():
    events = [StubEvent(done=True), StubEvent()]
    win = _window(3, events)
    got, deliver = _collector()
    src = _GatedSource()
    with _threads(src) as io:
        t0 = time.perf_counter()
        with pytest.raises(queue.Empty):
            io.get(0, timeout=0.05, idle=lambda: win.poll(deliver))
        assert time.perf_counter() - t0 >= 0.05
        src.release()  # lets the reader thread end
    assert got == [0] and len(win.pending) == 1


def _frames(n, size=(16, 24)):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, size=(*size, 3), dtype=np.uint8), t / 60.0) for t in range(n)]


@pytest.mark.parametrize("inflight", [3, 0])
def test_stream_counts_every_output_and_the_early_ones(inflight):
    """On the CPU a copy is complete at once, so `stream()` hands each
    output over at its own push: early with a window, not without one."""
    stats = stream(CompositeFilter((IdentityFilter(),)), iter(_frames(7)), lambda px, ts: None,
                   inflight=inflight, device="cpu")
    assert stats.frames_out == stats.frames_in == 7
    assert stats.session.counters["window.outputs"] == 7
    assert stats.session.counters.get("window.early", 0) == (7 if inflight else 0)


def test_stream_multi_counts_every_tick_handed_over():
    stats = stream_multi(CompositeFilter((IdentityFilter(),)), [iter(_frames(5)), iter(_frames(4))],
                         lambda i, px, ts: None, device="cpu")
    assert stats.per_stream_out == [5, 4]
    assert stats.session.counters["window.outputs"] == stats.batches
    assert stats.session.counters["window.early"] == stats.batches


@pytest.mark.cuda
def test_stream_hands_paced_outputs_over_within_a_frame_period():
    """From a reader paced at 60 fps with an in-flight window of 3, the
    median submit-to-hand-over latency is under one frame period (holding
    each output behind the window took three), and the paced outputs go
    early.  The first frames come as fast as they are taken, so that the
    capture and the backlog behind it are over before the pacing starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fps, closed, paced = 60.0, 30, 60
    frames = [f for f, _ in _frames(8, size=(120, 160))]

    def reader():
        t0 = None
        for k in range(closed + paced):
            if k >= closed:
                t0 = time.perf_counter() if t0 is None else t0
                wait = t0 + (k - closed) / fps - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            yield frames[k % len(frames)], k / fps

    stats = stream(dryrun.tiny_flagship(), reader(), lambda px, ts: None, inflight=3, device="cuda")
    assert stats.frames_in == closed + paced
    lat = stats.latencies[-paced // 2:]
    assert np.median(lat) < 1.0 / fps, np.median(lat)
    assert stats.session.counters["window.early"] >= paced // 2, stats.session.counters
