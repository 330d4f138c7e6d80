"""driver_wait_ms[.<cell suffix>] (layer: driver, `runtime/stream.py`):
the median of the solo driver's own `StreamStats.latencies` over the
window's outputs, submit to drain (the in-flight window's wait, without
the reader's and the writer's), ms.  Moves `latency_p50_ms`."""

import statistics


def read(run):
    lat = run.program.get("driver_latencies")
    if not lat:
        return None
    return 1000.0 * statistics.median(lat)
