"""What the readers of the program's own trace compute: its stage marks in
the traced slice, and the span tables and counters of its driver sessions
(`livevisionkit_tpu_torch.utils.profiling`).

Stage marks.  While a profiler records, the program's compiled step holds an
empty marker kernel at the start and at the end of each stage (`profiling.
STAGES`; `lvk_stage_mark<ID>`), so in every replay of the slice a stage's
time is the device busy time of the kernels between its marks, summed over
its intervals in that replay.  The slice's kernels split into its replays in order, each
replay running the same graph.

Sessions.  Every `process_clip`, `stream` and `stream_multi` call keeps a
session: its kind, whether a profiler recorded when it began, its frames
(ticks), the durations of each named span and its counters
(`profiling.sessions()`, the last 32).  The window's sessions are those
that ran with no profiler: a clip cell's are its calls over the whole clip
(the warm-up call is shorter), a live cell's is its one window.

Every reader returns None where it finds nothing: without a CUDA slice, or
with a program that has no stage marks or no sessions."""

from __future__ import annotations

import statistics

from harness.trace import busy_us

# The session kind of each driver of the benchmark.
KINDS = {"clip": "clip", "live": "stream", "multi": "multi"}


def _profiling():
    from livevisionkit_tpu_torch.utils import profiling

    return profiling


def replays(sl) -> list[list] | None:
    """The slice's kernels cut into its replays, in order (None where they
    do not divide evenly: the replays ran different graphs)."""
    if sl is None or not sl.replays or len(sl.kernels) % sl.replays:
        return None
    k = len(sl.kernels) // sl.replays
    return [sl.kernels[i * k:(i + 1) * k] for i in range(sl.replays)]


def stage_intervals(kernels: list, stage_of) -> dict[str, list[tuple[float, float]]]:
    """Each stage's (start, end) intervals in one replay's kernels, from the
    start times of its marks; `stage_of(name)` gives a mark's (stage, end)
    or None."""
    open_at: dict[str, list[float]] = {}
    out: dict[str, list[tuple[float, float]]] = {}
    for start, _, name in kernels:
        mark = stage_of(name)
        if mark is None:
            continue
        stage, end = mark
        if not end:
            open_at.setdefault(stage, []).append(start)
        elif open_at.get(stage):
            out.setdefault(stage, []).append((open_at[stage].pop(), start))
    return out


def stage_split(sl, stage_of) -> list[dict[str, float]] | None:
    """Per replay: each marked stage's device busy time (ms): the union of
    the kernels that start inside its intervals, marks left out; `busy`,
    the replay's own (ms); `replay`, its time from its first kernel's start
    to its last kernel's end (ms); and `unmarked`, the part of that time
    outside every top-level stage's intervals (ms).  Busy, not the time
    between the marks: a traced replay's launch is slowed by the profiler,
    and the device waits inside the graph for its nodes."""
    groups = replays(sl)
    if groups is None:
        return None
    out = []
    for kernels in groups:
        spans = stage_intervals(kernels, stage_of)
        if not spans:
            return None
        work = [(s, e) for s, e, name in kernels if stage_of(name) is None]
        row = {stage: sum(busy_us([(s, e) for s, e in work if a <= s < b]) for a, b in iv) / 1000.0
               for stage, iv in spans.items()}
        total = (max(e for _, e, _ in kernels) - kernels[0][0]) / 1000.0
        marked = sum(b - a for st, iv in spans.items() if "." not in st for a, b in iv) / 1000.0
        row["busy"], row["replay"], row["unmarked"] = busy_us(work) / 1000.0, total, total - marked
        out.append(row)
    return out


def stage_ms(run, stage: str) -> float | None:
    """The median over the traced slice's replays of `stage`'s device busy
    time in a replay, ms."""
    profiling = _profiling()
    stage_of = getattr(profiling, "stage_of_kernel", None)
    if stage_of is None or run.slice is None:
        return None
    split = stage_split(run.slice, stage_of)
    if not split or any(stage not in row for row in split):
        return None
    return statistics.median(row[stage] for row in split)


def _sessions(run, profiled: bool) -> list:
    """The run's sessions of its driver's kind that began with (or without)
    a profiler recording; a clip cell's only those over its whole clip."""
    read = getattr(_profiling(), "sessions", None)
    if read is None:
        return []
    kind = KINDS.get(run.cell.traffic["driver"])
    found = [s for s in read() if s.kind == kind and s.profiled == profiled]
    if kind == "clip" and not profiled:
        frames = run.program.get("frames")
        n = None if frames is None else frames.shape[0]
        found = [s for s in found if s.frames == n]
    return found


def window_sessions(run) -> list:
    """The window's sessions: for a live cell its one window (the last), for
    a clip cell every call over the whole clip."""
    found = _sessions(run, profiled=False)
    return found if run.cell.traffic["driver"] == "clip" else found[-1:]


def traced_session(run):
    """The last session that began while the profiler recorded."""
    found = _sessions(run, profiled=True)
    return found[-1] if found else None


def span_ms(run, name: str, minus: tuple[str, ...] = ()) -> float | None:
    """The median over the window's sessions of every `name` span, each less
    its time in the child spans named in `minus`, ms."""
    times = [t for s in window_sessions(run) if name in s.spans for t in s.spans[name].times(minus)]
    return 1000.0 * statistics.median(times) if times else None


def child_ms(run, name: str, child: str) -> float | None:
    """The median over the window's `name` spans of their time in child
    spans named `child` (0 where a span holds none), ms."""
    times = [t for s in window_sessions(run) if name in s.spans for t in s.spans[name].child_times(child)]
    return 1000.0 * statistics.median(times) if times else None


def counter_share(run, part: str, whole: str) -> float | None:
    """Counter `part` over counter `whole` of the traced session, in %."""
    sess = traced_session(run)
    if sess is None or not sess.counters.get(whole):
        return None
    return 100.0 * sess.counters.get(part, 0) / sess.counters[whole]

