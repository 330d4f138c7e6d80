"""The port's host utilities against the JAX package's: `TickTimer`,
`RecordLogger` and `CSVLogger` give the same outputs on the same calls,
and `DeviceTrace` records the runtime's frame and stage spans."""

import io
import json
import os
import time

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
    frame spans and the runtime's stage spans."""
    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.runtime.stream import stream

    frames = [(np.full((24, 32, 3), 100 + t, np.uint8), t / 30.0) for t in range(3)]
    logdir = str(tmp_path / "trace")
    with tprof.DeviceTrace(logdir, device="cpu") as tr:
        stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), iter(frames), device="cpu")
    assert tr.path == os.path.join(logdir, "trace.json")
    names = {e.get("name") for e in json.load(open(tr.path))["traceEvents"]}
    assert {"frame#0", "frame#1", "frame#2", "upload", "step", "download"} <= names
    with tprof.DeviceTrace(None):  # no directory: a no-op
        pass
