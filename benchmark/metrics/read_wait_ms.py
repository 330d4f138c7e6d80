"""read_wait_ms[.<cell suffix>] (layer: driver, `runtime/multistream.py`):
the median over the window session's `tick` spans of their `read_wait`
child (the wait for a frame of every stream), ms.  Moves
`frames_per_s.multi`."""

from harness import program_trace


def read(run):
    return program_trace.child_ms(run, "tick", "read_wait")
