"""The readers of the program's own trace (harness/program_trace.py and the
metrics that use it) on a synthetic slice of stage marks and synthetic
driver sessions: each reads what it should, and None where the slice or
the program has nothing to read (as a program without stage marks or
sessions has not)."""

from types import SimpleNamespace

import pytest
import torch

from tiny import BENCH  # noqa: F401

from harness import manifest, program_trace
from harness.trace import Slice
from livevisionkit_tpu_torch.utils import profiling

NEW = ("tracker_in_step_ms", "ransac_in_step_ms", "warp_in_step_ms", "ransac_inlier_share", "capture_ms",
       "capture_ms.4k_chain", "mesh_solve_in_step_ms", "deblock_in_step_ms", "cas_in_step_ms",
       "download_ms.live60", "host_tick_ms.multi", "read_wait_ms.multi", "download_ms.multi")


def _mark(t, stage, end):
    return (t, t + 1.0, f"void {profiling.mark_kernel_name(stage, end)}()")


def _replay(t0, tracker_us, ransac_us, warp_us):
    """One replay's kernels from t0 (us): ingest, tracker (holding
    tracker.ransac), a kernel outside every stage, warp, egress."""
    t = t0
    ks = [_mark(t, "ingest", False), (t + 1, t + 5, "copy"), _mark(t + 5, "ingest", True)]
    t += 6
    ks += [_mark(t, "tracker", False), _mark(t + 1, "tracker.ransac", False),
           (t + 2, t + 1 + ransac_us, "score"), _mark(t + 1 + ransac_us, "tracker.ransac", True),
           (t + 2 + ransac_us, t + tracker_us, "fast"), _mark(t + tracker_us, "tracker", True)]
    t += tracker_us + 1
    ks += [(t, t + 9, "servo")]  # outside every stage: 14 us a replay with the gaps
    t += 10
    ks += [_mark(t, "warp", False), (t + 1, t + warp_us, "warp_kernel"), _mark(t + warp_us, "warp", True)]
    t += warp_us + 1
    ks += [_mark(t, "egress", False), (t + 1, t + 3, "copy"), _mark(t + 3, "egress", True)]
    return ks


def _slice():
    kernels = _replay(0.0, 2000, 1500, 400) + _replay(10000.0, 3000, 1700, 600) + \
        _replay(20000.0, 2600, 1600, 500)
    return Slice(kernels=kernels, replays=3, window_us=kernels[-1][1])


def _run(driver="clip", sl=None, frames=480):
    cell = SimpleNamespace(traffic={"driver": driver})
    return SimpleNamespace(cell=cell, slice=sl, program={"frames": torch.zeros(frames, 1, 1, 1)})


def _session(kind, profiled=False, frames=0, spans=(), counters=None):
    s = profiling.Session(kind)
    s.profiled, s.frames = profiled, frames
    for name, seconds, children in spans:
        s.add(name, seconds, children)
    s.counters = dict(counters or {})
    return s


@pytest.fixture
def sessions(monkeypatch):
    found = []
    monkeypatch.setattr(profiling, "sessions", lambda: list(found))
    return found


def test_every_new_metric_has_a_reader_and_an_entry():
    per_layer = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name in NEW:
        assert hasattr(manifest.metric_reader(name), "read")
        assert per_layer[name]["workloads"] and per_layer[name]["source"] in ("program_span", "program_counter")


def test_stage_readers_take_the_median_replay():
    run = _run(sl=_slice())
    read = lambda name: manifest.metric_reader(name).read(run)  # noqa: E731
    # Busy between the marks, marks left out: tracker 2600 us less its
    # child's two marks and the fast kernel's 1 us start after them.
    assert read("tracker_in_step_ms") == pytest.approx(2.597)
    assert read("ransac_in_step_ms") == pytest.approx(1.599)
    assert read("warp_in_step_ms") == pytest.approx(0.499)
    split = program_trace.stage_split(run.slice, profiling.stage_of_kernel)
    assert [round(r["unmarked"] * 1000) for r in split] == [14, 14, 14]
    assert [round(r["busy"] * 1000) for r in split] == [2411, 3611, 3111]
    assert all(r["replay"] > r["busy"] for r in split)
    # Stages the step does not run read nothing.
    assert read("deblock_in_step_ms") is None and read("mesh_solve_in_step_ms") is None


def test_stage_readers_read_nothing_without_marks(monkeypatch):
    assert program_trace.stage_ms(_run(sl=None), "tracker") is None
    plain = Slice(kernels=[(0.0, 5.0, "copy"), (10.0, 15.0, "copy")], replays=2, window_us=15.0)
    assert program_trace.stage_ms(_run(sl=plain), "tracker") is None
    uneven = Slice(kernels=_slice().kernels[:-1], replays=3, window_us=1.0)
    assert program_trace.stage_ms(_run(sl=uneven), "tracker") is None
    monkeypatch.delattr(profiling, "stage_of_kernel")  # a program without stage marks
    assert program_trace.stage_ms(_run(sl=_slice()), "tracker") is None


def test_capture_reads_the_window_calls_over_the_whole_clip(sessions):
    sessions += [
        _session("clip", frames=32, spans=[("capture", 5.0, None)]),  # the warm-up call
        _session("clip", frames=480, spans=[("capture", 0.16, None), ("replays", 1.0, None)]),
        _session("clip", frames=480, spans=[("capture", 0.20, None)]),
        _session("clip", frames=480, spans=[("capture", 0.12, None)]),
        _session("clip", profiled=True, frames=12, spans=[("capture", 3.0, None)]),
        _session("stream", frames=480, spans=[("capture", 9.0, None)]),
    ]
    read = manifest.metric_reader("capture_ms").read
    assert read(_run("clip")) == pytest.approx(160.0)
    assert read(_run("clip", frames=120)) is None


def test_driver_readers_read_the_window_session(sessions):
    tick = [("tick", 0.015, {"read_wait": 0.004, "drain_wait": 0.003, "upload": 0.001}),
            ("tick", 0.020, {"read_wait": 0.002, "drain_wait": 0.010}),
            ("tick", 0.010, None)]  # a flush tick: no wait
    sessions += [
        _session("multi", spans=tick + [("download", 0.0005, None), ("download", 0.0007, None),
                                        ("download", 0.0009, None)]),
        _session("multi", profiled=True, spans=[("download", 0.05, None), ("tick", 0.2, None)]),
        _session("stream", spans=[("download", 0.001, None), ("download", 0.002, None)]),
    ]
    multi, live = _run("multi"), _run("live")
    assert manifest.metric_reader("host_tick_ms.multi").read(multi) == pytest.approx(8.0)
    assert manifest.metric_reader("read_wait_ms.multi").read(multi) == pytest.approx(2.0)
    assert manifest.metric_reader("download_ms.multi").read(multi) == pytest.approx(0.7)
    assert manifest.metric_reader("download_ms.live60").read(live) == pytest.approx(1.5)
    # The last window session of its kind; none read nothing.
    sessions.append(_session("stream", spans=[("download", 0.004, None)]))
    assert manifest.metric_reader("download_ms.live60").read(live) == pytest.approx(4.0)
    sessions.clear()
    assert manifest.metric_reader("download_ms.live60").read(live) is None
    assert manifest.metric_reader("host_tick_ms.multi").read(multi) is None


def test_inlier_share_reads_the_traced_session(sessions):
    read = manifest.metric_reader("ransac_inlier_share").read
    sessions.append(_session("clip", frames=480, counters={"ransac.inliers": 1, "ransac.tracked": 2}))
    assert read(_run("clip")) is None  # untraced sessions hold no device counter
    sessions.append(_session("clip", profiled=True, frames=12,
                             counters={"ransac.inliers": 4500, "ransac.tracked": 6000,
                                       "ransac.hypotheses": 3072}))
    assert read(_run("clip")) == pytest.approx(75.0)


def test_session_readers_read_nothing_without_sessions(monkeypatch):
    monkeypatch.delattr(profiling, "sessions")  # a program without sessions
    for name in ("capture_ms", "ransac_inlier_share"):
        assert manifest.metric_reader(name).read(_run("clip")) is None
    for name in ("download_ms.multi", "host_tick_ms.multi", "read_wait_ms.multi"):
        assert manifest.metric_reader(name).read(_run("multi")) is None

