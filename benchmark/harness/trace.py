"""The profiled slice of a traced run: `torch.profiler` over a short steady
stretch of the timed path, reduced to the kernels the program's CUDA graph
replays ran.

A kernel belongs to a replay when its correlation id is that of a
`cudaGraphLaunch` call; kernels that ran op by op (a capture's warm-up
steps) are left out.  The slice's window runs from the first replay's
launch to the last replay kernel's end."""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field


@dataclass
class Slice:
    kernels: list  # (start_us, end_us, name) of every replayed kernel, by start
    replays: int  # cudaGraphLaunch calls that ran kernels
    window_us: float
    host: list = field(default_factory=list)  # (start_us, end_us, name) host events

    def busy_us(self) -> float:
        return busy_us([(s, e) for s, e, _ in self.kernels])

    def named(self, pattern) -> list:
        return [k for k in self.kernels if pattern.search(k[2])]


def busy_us(intervals: list) -> float:
    """The union of (start, end) intervals sorted by start, in us."""
    busy, end = 0.0, intervals[0][0] if intervals else 0.0
    for start, stop in intervals:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


class Profiler:
    """`torch.profiler` over CPU and CUDA activity, started and stopped by
    the caller (from any thread), read once stopped."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def read(self) -> Slice:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        return reduce(events)


def reduce(events: list) -> Slice:
    """A chrome trace's events -> the replays' slice."""
    launches = {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation", "python_function"):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
            if e.get("name") == "cudaGraphLaunch":
                launches[e.get("args", {}).get("correlation")] = float(e["ts"])
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                     for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"
                     and e.get("args", {}).get("correlation") in launches)
    used = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"} & set(launches)
    if not kernels:
        return Slice(kernels=[], replays=0, window_us=0.0, host=host)
    start = min(launches[c] for c in used)
    host.sort()
    return Slice(kernels=kernels, replays=len(used), window_us=kernels[-1][1] - start, host=host)


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without `void` and its argument list, cut to
    `limit` characters."""
    name = name.removeprefix("void ")
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(" and i > 0:
            name = name[:i]
            break
    return name[:limit]


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps inside the slice's kernels, each named by the innermost host
    event around its middle, in seconds."""
    per = {}
    for s, e, name in sl.kernels:
        name = short_name(name)
        per[name] = per.get(name, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], sl.kernels[0][0] if sl.kernels else 0.0
    for s, e, _ in sl.kernels:
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    gaps = sorted(gaps, reverse=True)[:top]
    named = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        around = [h for h in sl.host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "host idle"
        named.append([label, length * 1e-6])
    return {"device_ops": [[n, t * 1e-6] for n, t in ops], "idle_gaps": named}
