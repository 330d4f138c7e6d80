"""`correct` over a two-plane scene: each sampled output of the timed path
against the plain two-plane reference (`reference.parallax`), judged
separately inside each plane's clear region (`reference.compare_planes`),
and the largest of each number over the samples and both regions against
the cell's limit.

The limits file gives, beside `harness.judge`'s keys, `clear_cells` (how
far from the foreground's edge, in cells of the mesh, a region keeps) and
`min_region_px` (the fewest pixels a region may hold in any sample: a
region that empties would judge nothing).  Besides `misalign_px` and
`residual_u8` the checks give `misalign_fg_px` and `misalign_bg_px`, each
plane's own (under the same limit), and `region_px_fg` and
`region_px_bg`, the fewest pixels each region held."""

from __future__ import annotations

import torch

from harness.judge import worst_of
from reference import compare_planes
from reference.parallax import PlaneChain

PLANES = ("fg", "bg")


def judge_plane_samples(run, chains: list[PlaneChain], samples: list) -> None:
    """`samples`: (stream, input index g, program output (C, H, W) float32)
    of outputs released by input g."""
    lim = run.cell.limits
    by_stream: dict[int, list] = {}
    for s, g, px in samples:
        by_stream.setdefault(s, []).append((g, px))
    readings: dict[str, list] = {k: [] for k in ("misalign_fg_px", "misalign_bg_px", "residual_u8",
                                                 "region_px_fg", "region_px_bg")}
    for s, items in by_stream.items():
        maps = chains[s].maps([g for g, _ in items])
        for g, px in items:
            ref = chains[s].output(g, maps[g]).to(run.device)
            prog = torch.as_tensor(px).to(run.device, torch.float32)
            regions = chains[s].regions(g, lim["clear_cells"], lim["interior_margin_px"])
            got = {}
            for plane in PLANES:
                mask = regions[plane].to(run.device)
                m, r = compare_planes.judge_region(prog, ref, mask)
                got[f"misalign_{plane}_px"], got[f"residual_{plane}_u8"] = m, r
                got[f"region_px_{plane}"] = float(mask.sum())
            for name in ("misalign_fg_px", "misalign_bg_px", "region_px_fg", "region_px_bg"):
                readings[name].append(got[name])
            readings["residual_u8"].append(worst_of([got["residual_fg_u8"], got["residual_bg_u8"]]))
            run.note(f"stream {s} input {g}: " + " ".join(f"{k} {v:.4f}" for k, v in got.items()))
            del ref, prog, regions
    run.check("outputs_compared", float(len(readings["residual_u8"])), float(lim["min_compared"]), below=False)
    fg, bg = worst_of(readings["misalign_fg_px"]), worst_of(readings["misalign_bg_px"])
    run.check("misalign_px", max(fg, bg), lim["misalign_px"])
    run.check("residual_u8", worst_of(readings["residual_u8"]), lim["residual_u8"])
    run.check("misalign_fg_px", fg, lim["misalign_px"])
    run.check("misalign_bg_px", bg, lim["misalign_px"])
    for plane in PLANES:
        counts = readings[f"region_px_{plane}"]
        run.check(f"region_px_{plane}", min(counts) if counts else 0.0, float(lim["min_region_px"]), below=False)
