"""The port's host utilities against the JAX package's: `TickTimer`,
`RecordLogger` and `CSVLogger` give the same outputs on the same calls,
and `DeviceTrace` records the runtime's frame and stage spans."""

import io
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from livevisionkit_tpu.utils import logging as jlog
from livevisionkit_tpu.utils import profiling as jprof
from livevisionkit_tpu_torch.utils import logging as tlog
from livevisionkit_tpu_torch.utils import profiling as tprof


def _drive_records(mod):
    buf = io.StringIO()
    log = mod.RecordLogger(buf, delimiter=",")
    log.record("a", 1, 2.5)
    log.write("frame", 7)
    log.begin_object()
    log.write("x", 1.0)
    log.begin_object()
    log.write("y")
    log.end_object()
    log.end_object()
    log.end_record()
    log.hold()
    log.record("held")
    before = buf.getvalue()
    log.resume()
    return before, buf.getvalue()


def test_record_logger_matches_jax():
    assert _drive_records(tlog) == _drive_records(jlog)
    assert _drive_records(tlog)[1] == "a,1,2.5\nframe,7,{x,1.0,{y}}\nheld\n"


def test_record_logger_rejects_unbalanced_objects():
    log = tlog.RecordLogger(io.StringIO())
    with pytest.raises(RuntimeError):
        log.end_object()
    log.begin_object()
    with pytest.raises(RuntimeError):
        log.end_record()


def test_csv_logger_matches_jax(tmp_path):
    texts = []
    for mod, name in ((jlog, "j.csv"), (tlog, "t.csv")):
        path = tmp_path / name
        with mod.CSVLogger(str(path), ["frame", "ms", "note"]) as log:
            log.record(frame=0, ms=1.5)
            log.record(frame=1, note="a,b")
            log.record(ms=np.float32(0.25))
        texts.append(path.read_text())
    assert texts[1] == texts[0]
    assert texts[1].splitlines()[0] == "frame,ms,note"


def _tick_sequence(mod):
    """(returns of a fixed schedule of ticks, tick counts) with sleeps long
    enough that the fixed-timestep decisions are not near a boundary."""
    t = mod.TickTimer()
    out = [t.tick() == 0.0]
    time.sleep(0.02)
    out.append(0.015 < t.tick() < 1.0)
    out.append(t.tick_count)
    t.reset()
    out.append(t.tick(0.05))  # arms, 0 elapsed
    out.append(t.tick(0.05))  # ~0 elapsed
    time.sleep(0.06)
    out.append(t.tick(0.05))  # elapsed
    out.append(t.tick(0.0))  # zero timestep: every tick fires
    out.append(t.tick_count)
    return out


def test_ticktimer_matches_jax():
    want = _tick_sequence(jprof)
    assert want == [True, True, 2, False, False, True, True, 2]
    assert _tick_sequence(tprof) == want


def test_device_trace_records_frame_and_stage_spans(tmp_path):
    """A CPU trace of a short stream: the Chrome trace exists and holds the
    frame spans and the driver's spans, and the session's table counts
    them."""
    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.runtime.stream import stream

    frames = [(np.full((24, 32, 3), 100 + t, np.uint8), t / 30.0) for t in range(3)]
    logdir = str(tmp_path / "trace")
    with tprof.DeviceTrace(logdir, device="cpu") as tr:
        stats = stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), iter(frames),
                       on_output=lambda px, ts: None, device="cpu")
    assert tr.path == os.path.join(logdir, "trace.json")
    names = [e.get("name") for e in json.load(open(tr.path))["traceEvents"]]
    driver = {"loop", "frame", "read_wait", "upload", "replay", "download", "deliver", "read", "write",
              "ingest", "egress"}
    assert driver <= set(names)
    assert names.count("frame") == 4  # three frames, and the wait that found the end
    sess = stats.session
    assert sess.kind == "stream" and sess.profiled and sess.frames == 3
    assert {name for name, *_ in sess.table()} == driver
    assert sess.spans["frame"].n == 3 and stats.frame_time.count == 2
    assert sess.spans["read_wait"].n == 4  # the wait that found the end, too
    with tprof.DeviceTrace(None):  # no directory: a no-op
        pass


class _Clock:
    """`time.perf_counter_ns` stepping 1 ms a call."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1_000_000
        return self.t


def test_session_aggregates_nested_spans_and_self_time(monkeypatch):
    monkeypatch.setattr(tprof, "_now", _Clock())
    with tprof.session("test") as sess:
        for _ in range(3):
            with tprof.trace_scope("outer"):
                with tprof.trace_scope("a"):
                    pass
                with tprof.trace_scope("b"):
                    with tprof.trace_scope("a"):
                        pass
                    with tprof.trace_scope("c"):
                        pass
                with tprof.trace_scope("a"):
                    pass
        tprof.count("things", 2)
        tprof.count("things")
        dropped = tprof.trace_scope("dropped")
        with dropped:
            with tprof.trace_scope("a"):
                pass
            dropped.discard()
    ms = lambda xs: [round(x * 1e3, 6) for x in xs]  # noqa: E731
    outer, a, b = sess.spans["outer"], sess.spans["a"], sess.spans["b"]
    # outer: 11 clock steps, of which "a" twice 1 and "b" 5 (holding an "a"
    # and a "c" of 1 each).
    assert outer.n == 3 and ms(outer.times()) == [11.0] * 3
    assert ms(outer.self_times()) == [4.0] * 3
    assert ms(outer.child_times("a")) == [2.0] * 3 and ms(outer.child_times("c")) == [0.0] * 3
    assert ms(outer.times(minus=("a",))) == [9.0] * 3
    assert b.n == 3 and ms(b.times()) == [5.0] * 3 and ms(b.self_times()) == [3.0] * 3
    assert ms(b.child_times("c")) == [1.0] * 3
    assert a.n == 10 and round(a.total * 1e3, 6) == 10.0
    assert "dropped" not in sess.spans
    assert sess.counters == {"things": 3}
    assert sess.table()[0][:2] == ("a", 10)
    assert tprof.sessions()[-1] is sess and not sess.profiled
    assert sess.watch("outer", skip=1).count == 2


def test_span_outside_a_session_and_after_it_records_nothing():
    with tprof.trace_scope("lonely"):
        tprof.count("lonely")
    with tprof.session("s") as sess:
        pass
    with tprof.trace_scope("late"):
        pass
    assert sess.spans == {} and sess.counters == {}


def test_session_ring_is_bounded():
    for k in range(tprof.SESSION_HISTORY + 5):
        with tprof.session(f"s{k}"):
            pass
    kept = tprof.sessions()
    assert len(kept) == tprof.SESSION_HISTORY
    assert [s.kind for s in kept[-2:]] == [f"s{tprof.SESSION_HISTORY + 3}", f"s{tprof.SESSION_HISTORY + 4}"]


def test_span_ring_is_bounded_and_counts_all():
    times = tprof.SpanTimes(history=4)
    for k in range(6):
        times.add(float(k))
    assert times.count == 4 and times.n == 6 and times.total == 15.0
    assert times.times() == [2.0, 3.0, 4.0, 5.0] and times.quantile(0.95) == 5.0
    assert tprof.SPAN_HISTORY >= 4096


def test_threads_add_to_one_session_without_losing_spans():
    """More threads than cores, a short switch interval: every span of every
    thread is counted once."""
    import sys
    import threading

    n_threads, per = 4 * (os.cpu_count() or 2), 300
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tprof.session("threads") as sess:
            def work():
                with sess.active():
                    for _ in range(per):
                        with tprof.trace_scope("read"):
                            tprof.count("items")
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(was)
    assert sess.spans["read"].n == n_threads * per
    assert sess.counters["items"] == n_threads * per


def _spy(monkeypatch):
    """Record every profiler range and marker launch a span makes, as if on
    a card capturing a graph."""
    calls = []

    class Range:
        def __init__(self, name, args=None):
            self.name = name

        def __enter__(self):
            calls.append(("open", self.name))

        def __exit__(self, *exc):
            calls.append(("close", self.name))

    monkeypatch.setattr(tprof._autograd_profiler, "record_function", Range)
    monkeypatch.setattr(tprof.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof.torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(tprof.torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))

    class Library:
        def lvk_mark_stage(self, mark_id, stream):
            calls.append(("mark", mark_id))
            return 0

    monkeypatch.setattr(tprof, "_marks", Library)
    return calls


def _stage_spans():
    with tprof.trace_scope("tracker"):
        with tprof.trace_scope("tracker.ransac"):
            pass
    with tprof.trace_scope("upload"):  # a driver span: no mark
        pass


def test_span_while_tracing_off_opens_no_range_and_launches_no_mark(monkeypatch):
    calls = _spy(monkeypatch)
    assert not tprof.tracing()
    with tprof.session("off"):
        _stage_spans()
    _stage_spans()
    assert calls == []


def test_stage_spans_while_tracing_mark_each_boundary_in_order(monkeypatch):
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tprof._autograd_profiler, "_is_profiler_enabled", True)
    assert tprof.tracing()
    _stage_spans()
    ids = {(st, end): int(tprof.mark_kernel_name(st, end).split("<")[1][:-1])
           for st in tprof.STAGES for end in (False, True)}
    assert calls == [
        ("open", "tracker"), ("mark", ids["tracker", False]),
        ("open", "tracker.ransac"), ("mark", ids["tracker.ransac", False]),
        ("mark", ids["tracker.ransac", True]), ("close", "tracker.ransac"),
        ("mark", ids["tracker", True]), ("close", "tracker"),
        ("open", "upload"), ("close", "upload"),
    ]


def test_span_while_profiling_lands_in_the_chrome_trace(tmp_path):
    with tprof.DeviceTrace(str(tmp_path), device="cpu") as tr:
        with tprof.trace_scope("frame", 7):
            with tprof.trace_scope("tracker.ransac"):
                pass
    events = json.load(open(tr.path))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"frame", "tracker.ransac"} <= set(spans)
    assert spans["frame"]["ts"] <= spans["tracker.ransac"]["ts"]


def test_stages_round_trip_through_mark_kernel_names():
    assert 2 * len(tprof.STAGES) <= tprof.MAX_MARKS and len(set(tprof.STAGES)) == len(tprof.STAGES)
    for st in tprof.STAGES:
        for end in (False, True):
            name = f"void {tprof.mark_kernel_name(st, end)}()"
            assert tprof.stage_of_kernel(name) == (st, end)
    assert tprof.stage_of_kernel("void lk_kernel<32>(float const*)") is None
    assert tprof.stage_of_kernel(f"void lvk_stage_mark<{2 * len(tprof.STAGES)}>()") is None


def test_signature_differs_by_tracing_state(monkeypatch):
    import torch
    import torch.utils._pytree as pytree

    from livevisionkit_tpu_torch.utils import compiled

    leaves, spec = pytree.tree_flatten((torch.zeros(3), (torch.ones(2),)))
    off = compiled.signature(leaves, spec)
    monkeypatch.setattr(tprof._autograd_profiler, "_is_profiler_enabled", True)
    on = compiled.signature(leaves, spec)
    assert off != on and off[:2] == on[:2]


def test_device_counters_count_only_while_tracing_and_outside_vmap(monkeypatch):
    import torch

    x = torch.tensor([1, 2, 3])
    with tprof.session("untraced") as quiet:
        tprof.count_on_device("test.items", x.sum(), x.device)
    monkeypatch.setattr(tprof._autograd_profiler, "_is_profiler_enabled", True)
    with tprof.session("traced") as loud:
        tprof.count_on_device("test.items", x.sum(), x.device)
        tprof.count_on_device("test.items", 4, x.device)
        torch.func.vmap(lambda v: (tprof.count_on_device("test.items", v.sum(), v.device), v)[1])(x[:, None])
    assert "test.items" not in quiet.counters
    assert loud.profiled and loud.counters["test.items"] == 10


def test_traced_clip_session_counts_ransac_and_spans_the_call(monkeypatch):
    """`process_clip` under a CPU profiler: one session with its capture and
    replays spans, the tracker's stage spans each frame, and RANSAC's
    counters; the same call untraced has no counter."""
    import torch

    from livevisionkit_tpu_torch.parallel.dryrun import tiny_flagship
    from livevisionkit_tpu_torch.runtime.offline import process_clip
    from livevisionkit_tpu_torch.types import PixelFormat

    filt = tiny_flagship()
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 3, 96, 128)).astype(np.float32))
    process_clip(filt, clip, PixelFormat.YUV, device="cpu")
    untraced = tprof.sessions()[-1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        process_clip(filt, clip, PixelFormat.YUV, device="cpu")
    traced = tprof.sessions()[-1]
    assert (untraced.kind, untraced.frames, untraced.profiled) == ("clip", 4, False)
    assert (traced.kind, traced.frames, traced.profiled) == ("clip", 4, True)
    assert traced.spans["replays"].n == 1 and "capture" not in traced.spans  # no graph on the CPU
    assert traced.spans["tracker"].n == 4 and traced.spans["tracker.ransac"].n == 4
    assert not any(k.startswith("ransac.") for k in untraced.counters)
    hyp = filt.settings.tracker.motion.hypotheses
    assert traced.counters["ransac.hypotheses"] == 4 * hyp
    assert 0 <= traced.counters["ransac.inliers"] <= traced.counters["ransac.tracked"]
