"""deblock_in_step_ms (layer: filters, `filters/deblocking.py`): the
`deblock` stage inside the cell's own captured step (beside the chain's
other filters, where `deblock_ms` times it alone), the median over the
traced slice's replays, ms.  Moves `frames_per_s.4k_chain`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "deblock")
