"""What one run of one cell carries between the command line, its driver,
the per-layer readers and the result line."""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any

from harness.manifest import Cell, metric_reader


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux: its
    start time in /proc against the uptime; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    started: float  # process start, perf_counter clock
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)  # name -> value
    checks: dict = field(default_factory=dict)  # name -> (value, limit, passed)
    layers: dict = field(default_factory=dict)  # per-layer name -> value
    memory_peak: int = 0
    slice: Any = None  # trace.Slice of the traced run
    frames_per_replay: int = 1  # output frames a graph replay delivers
    work: dict = field(default_factory=dict)  # the cell's kernel shapes, for the rooflines
    # What the readers may time, in every driver's traced run: "filter" (the
    # cell's filter as the window ran it), "frames" ((T, C, H, W) float32
    # frames on the device, as the filter takes them in: the clip, or the
    # first stream's ring), "format" (their PixelFormat); a driver may add
    # keys of its own.
    program: dict = field(default_factory=dict)

    def note(self, what: str) -> None:
        """A line on standard error, with the seconds since the process
        started (set-up phases, per-sample readings)."""
        print(f"[{time.perf_counter() - self.started:8.3f} s] {what}", file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float, below: bool = True) -> None:
        """A compared number and its limit (`below`: the value must not
        exceed it; else it must not fall under it)."""
        self.checks[name] = (value, limit, value <= limit if below else value >= limit)

    def correct(self) -> bool:
        """The run's `correct`: every offered frame delivered valid, and
        every compared number within its limit."""
        return self.failed == 0 and bool(self.checks) and all(ok for _, _, ok in self.checks.values())

    def read_layers(self) -> None:
        """Each per-layer metric of the cell from its reader; a reader that
        finds nothing returns None and the metric is left out."""
        for m in self.cell.per_layer:
            value = metric_reader(m["name"]).read(self)
            if value is not None:
                self.layers[m["name"]] = float(value)

    def step_busy_ms(self) -> float | None:
        """Device busy time per output frame in the traced slice, ms."""
        if self.slice is None or not self.slice.replays:
            return None
        return self.slice.busy_us() / 1000.0 / (self.slice.replays * self.frames_per_replay)
