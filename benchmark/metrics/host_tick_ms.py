"""host_tick_ms[.<cell suffix>] (layer: driver, `runtime/multistream.py`):
the median over the window session's `tick` spans of each less its
`read_wait` and `drain_wait` children: the host's own work a tick
(assembly, upload, replay launch, download, fan-out), ms.  Moves
`frames_per_s.multi`."""

from harness import program_trace


def read(run):
    return program_trace.span_ms(run, "tick", minus=("read_wait", "drain_wait"))
