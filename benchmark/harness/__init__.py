"""The benchmark's shared parts: the manifest and the files it names
(manifest.py), what a run carries (runctx.py), building the port's filter
from a configuration file (build.py), the traffic generator (render.py),
the profiler slice (trace.py), the roofline counts (roofline.py), the
per-layer arithmetic (layers.py), a stage timed alone as a CUDA graph
(stage.py) and the judge of `correct` (judge.py).  Nothing here imports
the port at import time."""
