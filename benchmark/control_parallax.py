"""The control of `correct` in a two-plane cell: `control.py`'s control (the
plain reference put in the program's place and computed in bfloat16, one
precision below the configuration's float32, judged as a run of the cell
judges the program) with the two-plane reference and the plane-by-plane
judge.  It has to come out not correct.

    python3 benchmark/control_parallax.py --workload vs1080_mesh_clip --seeds 11 12 13 --rate R

prints, for each seed, `correct` and the numbers compared with their
limits as one JSON line.  `--rate` is the cell's frames a second in a
sound run (the ledger's), from which the clip driver counts the inputs a
window offers.  Runs on any device (`--device`, default cuda); the
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from harness import manifest
from harness.judge_planes import judge_plane_samples
from harness.runctx import Run
from reference.parallax import PlaneChain


def control(cell, seed: int, seconds: float, rate: float | None, device, dtype=torch.bfloat16) -> dict:
    driver = importlib.import_module(f"drivers.{cell.traffic['driver']}")
    inputs, picks, _ = driver.control_inputs(cell, seed, seconds, rate, device)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=torch.device(device),
              started=time.perf_counter())
    samples = []
    for s, inp in enumerate(inputs):
        low = PlaneChain(cell.config, inp, dtype=dtype, device=device)
        for g, smap in low.maps([g for st, g in picks if st == s]).items():
            samples.append((s, g, low.output(g, smap)))
    run.attempted = len(samples)
    judge_plane_samples(run, [PlaneChain(cell.config, inp, device=device) for inp in inputs], samples)
    return {"seed": seed, "correct": run.correct(),
            "checks": {name: {"value": v, "limit": lim} for name, (v, lim, _) in run.checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    seconds = args.seconds if args.seconds is not None else manifest.load_manifest()["run_seconds"]
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, seconds, args.rate, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
