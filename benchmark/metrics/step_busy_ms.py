"""step_busy_ms[.<cell suffix>] (layer: compiled step, `utils/compiled.py`):
device busy time per output frame in the traced slice of graph replays
(the union of the replayed kernels' intervals over the frames they
delivered; with several streams, a tick's over its stream-frames), ms.
Moves the cell's rate, or in the paced cell its latency tail."""


def read(run):
    return run.step_busy_ms()
