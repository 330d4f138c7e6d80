"""capture_ms[.<cell suffix>] (layer: compiled step, `utils/compiled.py`,
`runtime/offline.py`): the median over the window's `process_clip` calls
of the call's `capture` span (its compiled step's op-by-op warm-up steps
and the capture of its graph), ms.  Moves the cell's rate."""

from harness import program_trace


def read(run):
    return program_trace.span_ms(run, "capture")
