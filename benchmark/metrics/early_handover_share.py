"""early_handover_share[.<cell suffix>] (layer: driver, `runtime/pipeline.py`
`Window`): the outputs handed over as soon as their copies completed, while
no more than `inflight` were pending, over every output handed over, in the
traced session (the program's `window.early` and `window.outputs`
counters), in %.  Moves `latency_p50_ms`."""

from harness import program_trace


def read(run):
    return program_trace.counter_share(run, "window.early", "window.outputs")
