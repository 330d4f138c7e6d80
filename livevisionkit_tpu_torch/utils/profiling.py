"""Frame timing instrumentation (counterpart of
livevisionkit_tpu/utils/profiling.py; reference Timing/Stopwatch.cpp,
Timing/TickTimer.hpp and the OBS plugin's ScopedProfiler).

`Stopwatch` keeps a ring of intervals.  In throughput mode the runtimes do
not wait for the device per frame, so a `tick` lap is the wall-clock
interval between frames, the honest streaming number.  `TickTimer` is the
delta / fixed-timestep timer of the CLI's rate-locked display.
`trace_scope` and `frame_scope` name spans on the `torch.profiler`
timeline, and `DeviceTrace` records one (host spans and, on a CUDA
device, its kernels) into a Chrome trace for the CLI's `--trace`.
"""

from __future__ import annotations

import contextlib
import math
import os
import statistics
import time
from collections import deque

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


@contextlib.contextmanager
def trace_scope(name: str):
    """Named span on the profiler timeline (reference LVK_PROFILE,
    ScopedProfiler.cpp:26-37); next to free when no profile is active."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def frame_scope(step: int):
    """Per-frame span, `frame#<step>`: groups the scopes and kernels of one
    frame (the unit the reference's profiler tree roots at)."""
    with torch.profiler.record_function(f"frame#{step}"):
        yield


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
            self._prof = torch.profiler.profile(activities=activities)
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
