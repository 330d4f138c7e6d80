"""Frame timing and the port's span-and-counter recorder (counterpart of
livevisionkit_tpu/utils/profiling.py; reference Timing/Stopwatch.cpp,
Timing/TickTimer.hpp and the OBS plugin's ScopedProfiler).

`Stopwatch` keeps a ring of intervals; `TickTimer` is the delta /
fixed-timestep timer of the CLI's rate-locked display; `DeviceTrace`
records a `torch.profiler` trace (host spans and, on a CUDA device, its
kernels) into a Chrome trace for the CLI's `--trace`.

Spans and counters.  `trace_scope(name)` is the one span of the program,
at three levels, with no switch of its own:

  * always, inside a driver's session (`session(kind)`: one `stream()`,
    `stream_multi()` or `process_clip()` call), its duration goes into the
    session's table under its name (`SpanTimes`: a ring of the last
    `SPAN_HISTORY` durations with each one's child spans, the count and the
    total), and into its parent span's children on the same thread;
  * while a `torch.profiler` records ("tracing", `tracing()`), it also opens
    a `record_function` of its name, so the span lies on the device trace's
    own clock;
  * while tracing, a span named in `STAGES` that opens or closes inside a
    CUDA graph being captured launches an empty marker kernel
    (`lvk_stage_mark<ID>`, csrc/trace.cu) on the capture stream, so every
    replay runs two marks a stage, in order, and their start times are the
    device times of the stage's boundaries.  Whether tracing is on is part
    of a compiled step's signature (utils/compiled.py), so a graph captured
    while tracing is off holds no mark.  On the CPU marks do nothing.

`count(name, n)` adds to the session's counters on the host;
`count_on_device(name, value)` adds a device value to a tensor the
recorder owns, only while tracing and outside `vmap`, and a session that
began while tracing reads those tensors once, when it ends.  Finished
sessions go into a ring of the last `SESSION_HISTORY` (`sessions()`).  A
span outside any session adds to no table.  Nothing is written out during
a run.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import re
import statistics
import threading
import time
from collections import deque
from typing import Iterator

import torch


class Stopwatch:
    """Ring buffer of the last `history` intervals, in seconds."""

    def __init__(self, history: int = 300):
        self._times = deque(maxlen=history)
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._t0 = None
        return dt

    def tick(self):
        """Lap timing: record the interval since the previous tick."""
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    @property
    def count(self) -> int:
        return len(self._times)

    def last(self) -> float:
        """Most recent interval (seconds; 0 before any sample)."""
        return self._times[-1] if self._times else 0.0

    def average(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def median(self) -> float:
        """The median interval: the steady pace, past a first interval
        that paid a capture or a compile (0 before any sample)."""
        return statistics.median(self._times) if self._times else 0.0

    def deviation(self) -> float:
        if len(self._times) < 2:
            return 0.0
        mean = self.average()
        var = sum((t - mean) ** 2 for t in self._times) / (len(self._times) - 1)
        return math.sqrt(var)

    def average_ms(self) -> float:
        return self.average() * 1000.0

    def deviation_ms(self) -> float:
        return self.deviation() * 1000.0


class TickTimer:
    """Delta/tick-count timer with an optional fixed timestep (reference
    Timing/TickTimer.hpp:24-43): `tick()` returns the time since the last
    tick; `tick(timestep)` returns True only once `timestep` has elapsed
    (fps-locked display, VideoProcessor.cpp:205-211)."""

    def __init__(self):
        self._last: float | None = None
        self._acc = 0.0
        self.tick_count = 0

    def tick(self, timestep: float | None = None) -> bool | float:
        now = time.perf_counter()
        delta = 0.0 if self._last is None else now - self._last
        self._last = now
        if timestep is None:
            self.tick_count += 1
            return delta
        self._acc += delta
        if self._acc >= timestep:
            self._acc = math.fmod(self._acc, timestep) if timestep > 0 else 0.0
            self.tick_count += 1
            return True
        return False

    def reset(self):
        self._last = None
        self._acc = 0.0
        self.tick_count = 0


# The ring of each span's durations: long enough for a whole 10 s window
# of every driver's per-frame and per-tick spans.
SPAN_HISTORY = 4096
# Finished sessions kept for `sessions()`.
SESSION_HISTORY = 32

# The stages whose boundaries are marked inside a captured graph, in a
# fixed order: the marker kernel of stage i is `lvk_stage_mark<2 i>` at its
# start and `lvk_stage_mark<2 i + 1>` at its end.  A dotted name is a child
# of the stage named by what precedes its last dot.  A new stage goes at
# the end, so that every other stage keeps its marks.
STAGES = (
    "ingest", "tracker", "tracker.pyramid", "tracker.lk", "tracker.ransac", "tracker.mesh",
    "tracker.fast", "smoother", "queue", "warp", "deblock", "cas", "egress", "donate",
    "tracker.mesh.assemble", "tracker.mesh.cg", "tracker.mesh.reweight",
)
_STAGE_IDS = {name: i for i, name in enumerate(STAGES)}
MARK_KERNEL = "lvk_stage_mark"
_MARK_NAME = re.compile(MARK_KERNEL + r"<(\d+)>")
MAX_MARKS = 64  # the marker kernels csrc/trace.cu instantiates

_autograd_profiler = torch.autograd.profiler


def tracing() -> bool:
    """Whether a `torch.profiler` is recording: one global read."""
    return _autograd_profiler._is_profiler_enabled


def mark_kernel_name(stage: str, end: bool) -> str:
    """The marker kernel launched at the start (or `end`) of `stage`."""
    return f"{MARK_KERNEL}<{2 * _STAGE_IDS[stage] + int(end)}>"


def stage_of_kernel(name: str) -> tuple[str, bool] | None:
    """(stage, end) of a marker kernel's name as a trace gives it (`void
    lvk_stage_mark<3>()`), or None for any other kernel."""
    m = _MARK_NAME.search(name)
    if m is None or int(m.group(1)) >= 2 * len(STAGES):
        return None
    i = int(m.group(1))
    return STAGES[i // 2], bool(i % 2)


class SpanTimes(Stopwatch):
    """One span's durations in a session, in seconds: the ring of the last
    `history` (a `Stopwatch`), each one's time in child spans by their
    names, and the count and total of all."""

    def __init__(self, history: int = SPAN_HISTORY):
        super().__init__(history)
        self._children: deque = deque(maxlen=history)
        self.n = 0
        self.total = 0.0

    def add(self, seconds: float, children: dict | None = None) -> None:
        self._times.append(seconds)
        self._children.append(children)
        self.n += 1
        self.total += seconds

    def merge(self, other: "SpanTimes") -> "SpanTimes":
        """A new record of both (the rings one after the other)."""
        out = SpanTimes(history=self._times.maxlen + other._times.maxlen)
        for rec in (self, other):
            out._times.extend(rec._times)
            out._children.extend(rec._children)
            out.n += rec.n
            out.total += rec.total
        return out

    def times(self, minus: tuple[str, ...] = ()) -> list[float]:
        """The ring's durations, each less its time in the named child
        spans."""
        if not minus:
            return list(self._times)
        return [t - sum(c.get(k, 0.0) for k in minus) if c else t
                for t, c in zip(self._times, self._children)]

    def child_times(self, name: str) -> list[float]:
        """Each span's time in its child spans named `name` (0 where none)."""
        return [c.get(name, 0.0) if c else 0.0 for c in self._children]

    def self_times(self) -> list[float]:
        """Each span's duration less the time its child spans cover."""
        return [t - sum(c.values()) if c else t for t, c in zip(self._times, self._children)]

    def quantile(self, q: float) -> float:
        """The `q` quantile of the ring (nearest rank; 0 before any span)."""
        if not self._times:
            return 0.0
        ts = sorted(self._times)
        return ts[min(len(ts) - 1, int(q * len(ts)))]


class _Thread:
    """A thread's part of an active session: its span table, which only
    that thread writes (so a span takes no lock), and its open spans."""

    __slots__ = ("session", "table", "stack")

    def __init__(self, session: "Session"):
        self.session = session
        self.table: dict[str, SpanTimes] = {}
        self.stack: list = []


class Session:
    """One driver call's record: its kind, whether a profiler was recording
    when it began, its frames (or ticks), the span table (`spans`: name ->
    `SpanTimes`, over all its threads) and the counters (name -> number)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.profiled = tracing()
        self.frames = 0
        self.ticks = 0
        self.counters: dict[str, float] = {}
        self._tables: list[dict[str, SpanTimes]] = [{}]
        self._lock = threading.Lock()

    @property
    def spans(self) -> dict[str, SpanTimes]:
        """The span table: each name's record over every thread."""
        out: dict[str, SpanTimes] = {}
        for table in list(self._tables):
            for name, rec in list(table.items()):
                out[name] = out[name].merge(rec) if name in out else rec
        return out

    def add(self, name: str, seconds: float, children: dict | None = None) -> None:
        """Add one span of `name` to the table (as a span that closed)."""
        with self._lock:
            rec = self._tables[0].get(name)
            if rec is None:
                rec = self._tables[0][name] = SpanTimes()
            rec.add(seconds, children)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def last(self, name: str) -> float:
        """The duration of the calling thread's last `name` span in this
        session (0 before any)."""
        th = _local.thread
        rec = th.table.get(name) if th is not None and th.session is self else self.spans.get(name)
        return rec.last() if rec is not None else 0.0

    def watch(self, name: str, skip: int = 0) -> Stopwatch:
        """The ring of `name` as a `Stopwatch`, past the session's first
        `skip` spans (where the ring still holds them)."""
        rec = self.spans.get(name) or SpanTimes()
        drop = max(0, skip - (rec.n - rec.count))
        sw = Stopwatch(history=SPAN_HISTORY)
        sw._times.extend(list(rec._times)[drop:])
        return sw

    def table(self) -> list[tuple[str, int, float, float]]:
        """(name, count, median ms, p95 ms) of every span, by name."""
        return [(name, rec.n, rec.median() * 1e3, rec.quantile(0.95) * 1e3)
                for name, rec in sorted(self.spans.items())]

    @contextlib.contextmanager
    def active(self) -> Iterator["Session"]:
        """Record the spans of the calling thread into this session inside
        the block (a driver's reader and writer threads enter it too)."""
        th = _Thread(self)
        with self._lock:
            self._tables.append(th.table)
        saved, _local.thread = _local.thread, th
        try:
            yield self
        finally:
            _local.thread = saved

    def close(self) -> None:
        """End the session: read the device counters if it began while
        tracing, and keep it in the ring of `sessions()`."""
        if self.profiled:
            for (_, name), acc in list(_DEVICE_COUNTERS.items()):
                self.count(name, acc.item())
        _SESSIONS.append(self)


class _Local(threading.local):
    thread: _Thread | None = None  # the calling thread's part of its active session


_local = _Local()
_SESSIONS: deque = deque(maxlen=SESSION_HISTORY)
# (device, name) -> the accumulator `count_on_device` adds to: one tensor
# for the life of the process, since a captured graph keeps its address.
_DEVICE_COUNTERS: dict[tuple[torch.device, str], torch.Tensor] = {}


@contextlib.contextmanager
def session(kind: str) -> Iterator[Session]:
    """A driver call's session, active on the calling thread inside the
    block and finished at its end (also when it raises).  A session that
    begins while tracing first zeroes the device counters."""
    sess = Session(kind)
    if sess.profiled:
        for acc in _DEVICE_COUNTERS.values():
            acc.zero_()
    try:
        with sess.active():
            yield sess
    finally:
        sess.close()


def sessions() -> list[Session]:
    """The last `SESSION_HISTORY` finished sessions, oldest first."""
    return list(_SESSIONS)


def count(name: str, n: float = 1) -> None:
    """Add `n` to the current session's counter `name` (nothing outside a
    session)."""
    th = _local.thread
    if th is not None:
        th.session.count(name, n)


def counting() -> bool:
    """Whether device counters count here: while tracing and outside `vmap`
    (a caller computes what it counts only then, so an untraced step gains
    no kernel)."""
    return _autograd_profiler._is_profiler_enabled and torch._C._functorch.maybe_current_level() is None


def count_on_device(name: str, value: torch.Tensor | int, device: torch.device) -> None:
    """Add `value` (a tensor or a number) on `device` to the recorder's
    counter `name` where `counting()`; inside a graph it adds on every
    replay, and nothing waits for it."""
    if not counting():
        return
    key = (torch.device(device), name)
    acc = _DEVICE_COUNTERS.get(key)
    if acc is None:
        if key[0].type == "cuda" and torch.cuda.is_current_stream_capturing():
            return  # an accumulator made inside a capture would start unset
        acc = _DEVICE_COUNTERS[key] = torch.zeros((), dtype=torch.int64, device=key[0])
    acc.add_(value)


@functools.cache
def _marks():
    """The kernel library's marker entry point (csrc/trace.cu), loaded, with
    every marker kernel loaded on the device."""
    from livevisionkit_tpu_torch.ops.cuda_kernels import build

    lib = build.library()
    build.check(lib.lvk_load_stage_marks(), "stage marks load")
    return lib


def _mark(stage: str, end: bool) -> None:
    """Launch the stage's marker kernel on the current stream when it is
    capturing a graph.  A traced step's op-by-op warm-up, which runs before
    its capture, loads the marker kernels instead (loading a kernel inside
    a capture is not allowed)."""
    if not torch.cuda.is_available():
        return
    lib = _marks()
    if torch.cuda.is_current_stream_capturing():
        from livevisionkit_tpu_torch.ops.cuda_kernels import build

        mark_id = 2 * _STAGE_IDS[stage] + int(end)
        build.check(lib.lvk_mark_stage(mark_id, torch.cuda.current_stream().cuda_stream), "stage mark")


class _Idle:
    """The span outside every session while tracing is off: nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Idle":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def discard(self) -> None:
        pass


_IDLE = _Idle()
_now = time.perf_counter_ns


def trace_scope(name: str, args=None):
    """A named span (reference LVK_PROFILE, ScopedProfiler.cpp:26-37), used
    as `with trace_scope(name):`; `args` (any value, made a string only
    while tracing) rides on its profiler range.  The module docstring gives
    its three levels."""
    th = _local.thread
    if th is None and not _autograd_profiler._is_profiler_enabled:
        return _IDLE
    return _Span(name, args, th)


class _Span:
    __slots__ = ("name", "args", "children", "_th", "_t0", "_rf")

    def __init__(self, name: str, args, th: _Thread | None):
        self.name = name
        self.args = args
        self.children = self._rf = None
        self._th = th

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        th = self._th
        if th is not None:
            th.stack.append(self)
            self._t0 = _now()
        return self

    def discard(self) -> None:
        """Leave this open span out of its session's table (the spans it
        holds stay); it must be the innermost open span."""
        if self._th is not None:
            self._th.stack.pop()
            self._th = None

    def _open(self) -> None:
        self._rf = _autograd_profiler.record_function(
            self.name, None if self.args is None else str(self.args))
        self._rf.__enter__()
        if self.name in _STAGE_IDS:
            _mark(self.name, False)

    def __exit__(self, exc_type, exc, tb) -> bool:
        th = self._th
        if th is not None:
            dt = (_now() - self._t0) * 1e-9
            name = self.name
            stack = th.stack
            stack.pop()
            if stack:
                parent = stack[-1]
                kids = parent.children
                if kids is None:
                    parent.children = {name: dt}
                else:
                    kids[name] = kids.get(name, 0.0) + dt
            rec = th.table.get(name)
            if rec is None:
                rec = th.table[name] = SpanTimes()
            # SpanTimes.add, inlined: this is the price of every span.
            rec._times.append(dt)
            rec._children.append(self.children)
            rec.n += 1
            rec.total += dt
        rf = self._rf
        if rf is not None:
            if self.name in _STAGE_IDS:
                _mark(self.name, True)
            rf.__exit__(exc_type, exc, tb)
        return False


def _all_threads():
    """The profiler's setting that records the ranges of every thread (the
    drivers' reader and writer threads too), where this PyTorch has it;
    else None, and only the thread that starts the profiler is recorded."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class DeviceTrace:
    """`torch.profiler` over a block for the CLI's --trace flag: host spans,
    and the kernels when `device` is a CUDA device, written on exit as a
    Chrome trace (`trace.json`, open in Perfetto or chrome://tracing) into
    `logdir`.  A None `logdir` makes it a no-op."""

    def __init__(self, logdir: str | None, device: torch.device | str = "cuda"):
        self.logdir = logdir
        self.device = torch.device(device)
        self.path = None if logdir is None else os.path.join(logdir, "trace.json")
        self._prof = None

    def __enter__(self):
        if self.logdir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities, experimental_config=_all_threads())
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            prof.export_chrome_trace(self.path)
        return False
