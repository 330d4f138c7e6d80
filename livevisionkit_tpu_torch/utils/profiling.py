"""Frame timing instrumentation (counterpart of
livevisionkit_tpu/utils/profiling.py; reference Timing/Stopwatch.cpp).

Only `Stopwatch` is ported so far, for the multi-stream driver's batch
timing (runtime/multistream.py).  In throughput mode the driver does not
wait for the device per batch, so a `tick` lap is the wall-clock interval
between batches, the honest streaming number.  The rest of the module
(TickTimer, the stage timers) waits for the runtime slice.
"""

from __future__ import annotations

import math
import time
from collections import deque


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
