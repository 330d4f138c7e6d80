"""download_ms[.<cell suffix>] (layer: driver, `runtime/stream.py`,
`runtime/multistream.py` on `runtime/transfer.py`): the median of the
window session's `download` spans (a frame's, or a tick's, start of the
copy of its outputs to the host), ms.  Moves the cell's latency tail or
rate."""

from harness import program_trace


def read(run):
    return program_trace.span_ms(run, "download")
