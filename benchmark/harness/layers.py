"""What the per-layer readers (metrics/<name>.py) compute from a traced
run: the slice's busy time and kernels a replay, the device's idle share
against the untraced window's rate, and a kernel's share of its roofline.
Each reader names the quantity (the rate metric is the mix's); these do the
arithmetic once."""

from __future__ import annotations

import re

from harness.roofline import easu_warp_bound_ms, lk_bound_ms

WARP_KERNELS = re.compile(r"(?<![A-Za-z0-9_])(easu|bilinear)_warp_kernel(?![A-Za-z0-9_])")
LK_KERNELS = re.compile(r"(?<![A-Za-z0-9_])lk_kernel(?![A-Za-z0-9_])")


def idle_share(run, rate_metric: str) -> float | None:
    """1 - busy ms a frame x frames a second / 1000, in %: the busy time
    from the traced slice, the rate from the untraced window (a profiled
    replay's launch is slowed by the profiler itself, so the slice's own
    timeline would overstate the idle)."""
    busy = run.step_busy_ms()
    rate = run.end_to_end.get(rate_metric)
    if busy is None or not rate:
        return None
    return 100.0 * (1.0 - busy * rate / 1000.0)


def kernels_per_replay(run) -> float | None:
    sl = run.slice
    if sl is None or not sl.replays:
        return None
    return len(sl.kernels) / sl.replays


def _share(run, pattern, bound_ms: float) -> float | None:
    """The bound over the matching kernels' time a replay, in %; None
    where the slice ran none of them."""
    sl = run.slice
    found = sl.named(pattern) if sl is not None and sl.replays else []
    if not found:
        return None
    ms = sum(e - s for s, e, _ in found) / 1000.0 / sl.replays
    return 100.0 * bound_ms / ms


def warp_roofline(run) -> float | None:
    """The warp's least time for the cell's work (every byte of its 8-bit
    planes and float32 maps moved once, or EASU's float32 operations counted
    from the cell's maps, whichever is longer) over the warp kernels' time;
    the kernels are found by name, and the work does not depend on which of
    them does it."""
    work = run.work.get("warp")
    if work is None:
        return None
    return _share(run, WARP_KERNELS, easu_warp_bound_ms(work["maps"], work["channels"], work["src_bytes"],
                                                        work["out_bytes"]))


def lk_roofline(run) -> float | None:
    """LK's least time for the cell's work (both float32 pyramids read once
    and 25 bytes a feature, or the kernel's float32 operations for every
    feature, level and iteration) over the LK kernel's time."""
    work = run.work.get("lk")
    if work is None:
        return None
    return _share(run, LK_KERNELS, lk_bound_ms(work["levels"], work["features"], work["window"],
                                               work["iterations"], work["streams"]))
