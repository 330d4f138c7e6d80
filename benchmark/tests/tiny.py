"""Small cells for the CPU tests: a cell of the manifest with its frame
size, detection size, grid and ring cut down so that the port's plain
(CPU) path runs a window in seconds.  Only the sizes change; the drivers,
the generator, the reference and the comparison are the cell's own."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

SIZE = (120, 160)


def tiny_cell(name: str, size=SIZE, ring: int = 24, **limits):
    """The manifest's cell `name` at `size`: detection at half the frame,
    a 6 x 8 grid, 32 hypotheses, 20 samples at least, a ring of `ring`
    frames; `limits` override the cell's."""
    cell = manifest.cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["size"] = list(size)
    tracker = cfg["filters"][0]["settings"]["tracker"]
    tracker["detection_size"] = [size[0] // 2, size[1] // 2]
    tracker["detector"]["grid_shape"] = [6, 8]
    tracker["min_motion_samples"] = 20
    tracker["motion"]["hypotheses"] = 32
    tr = copy.deepcopy(cell.traffic)
    tr.pop("ring_frames_at_1080p", None)
    tr["ring_frames"] = ring
    for key in ("warmup_frames", "closed_warmup_frames"):
        if key in tr:
            tr[key] = 16
    if "paced_warmup_frames" in tr:
        tr["paced_warmup_frames"] = 4
    if "streams" in tr:
        tr["streams"] = 2
    # At this size the tracker has 48 features and a pixel is a large share
    # of the frame: its error against the true path reads up to ~1.5 px
    # (the mesh) where the cells' own read far less in their pixels.
    lim = dict(cell.limits, interior_margin_px=8, min_compared=1, residual_u8=4.0, misalign_px=3.0)
    for key in lim:
        if key.endswith("_gap"):
            lim[key] = 0.5
    lim.update(limits)
    return manifest.Cell(name=cell.name, config=cfg, traffic=tr, limits=lim, chips=cell.chips,
                         end_to_end=cell.end_to_end, per_layer=cell.per_layer)
