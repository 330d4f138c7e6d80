"""`correct`: each sampled output of the timed path against the plain
reference's output for the same input, by `reference.compare.judge`, and
the largest of each number over the samples against the cell's limit."""

from __future__ import annotations

from typing import Callable

import torch

from reference import compare
from reference.stabilizer import Chain


def judge_samples(run, chains: list[Chain], samples: list, to_output: Callable | None = None) -> None:
    """`samples`: (stream, input index g, program output (C, H, W) float32)
    of outputs released by input g; `to_output` maps the reference's YUV
    planes to the program's output format.  Each further filter of the
    chain adds its gap (`<type>_gap`, compare.judge), held to the limit
    file's key of that name."""
    lim = run.cell.limits
    by_stream: dict[int, list] = {}
    for s, g, px in samples:
        by_stream.setdefault(s, []).append((g, px))
    readings: dict[str, list] = {"misalign_px": [], "residual_u8": []}
    for s, items in by_stream.items():
        maps = chains[s].maps([g for g, _ in items])
        for g, px in items:
            ref, changes = chains[s].stages(g, maps[g])
            if to_output is not None:
                ref = to_output(ref)
                changes = {k: to_output(d) - to_output(torch.zeros_like(d)) for k, d in changes.items()}
            m, r, gaps = compare.judge(torch.as_tensor(px).to(run.device, torch.float32), ref.to(run.device),
                                       lim["interior_margin_px"], {k: d.to(run.device) for k, d in changes.items()})
            got = {"misalign_px": m, "residual_u8": r, **{f"{k}_gap": v for k, v in gaps.items()}}
            for name, value in got.items():
                readings.setdefault(name, []).append(value)
            run.note(f"stream {s} input {g}: " + " ".join(f"{k} {v:.4f}" for k, v in got.items()))
            del ref, changes
    run.check("outputs_compared", float(len(readings["misalign_px"])), float(lim["min_compared"]), below=False)
    for name, values in readings.items():
        worst = worst_of(values)
        if lim[name] is None:  # a number this cell reads but does not compare
            run.note(f"{name} {worst!r} (not compared in this cell)")
        else:
            run.check(name, worst, lim[name])


def worst_of(values: list[float]) -> float:
    """The largest reading; infinite where there is none or one is NaN (a
    NaN compares false with everything and would hide in `max`)."""
    if not values or any(v != v for v in values):
        return float("inf")
    return max(values)


def sample_maps(config: dict, inputs: list, g: int, device) -> torch.Tensor:
    """(S, 2, H, W): each stream's stabilizer map at its input g, from a
    reference chain of its own (the warp's work, for the roofline)."""
    return torch.stack([Chain(config, i, device=device).maps([g])[g].float() for i in inputs])
