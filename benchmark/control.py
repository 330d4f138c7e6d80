"""The control of `correct`: the plain reference put in the program's place
and computed in bfloat16, one precision below the configuration's float32,
judged by the harness's own comparison (`harness.judge.judge_samples` on a
`Run` of the cell, with the cell's limits), as a run of the cell judges
the program.  It has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--seconds 10] [--rate R]

prints, for each seed, `correct` and the numbers compared with their
limits as one JSON line.  The inputs and the outputs compared are those a
run of the cell with that seed and window would have: the same rendered
ring, the same inputs by index, as many outputs, drawn the same way.
`--rate` is the cell's frames a second in a sound run (the ledger's), from
which the clip and multi-stream drivers count the inputs a window offers;
the live driver's reader sets its own.  Runs on any device (`--device`,
default cuda); the benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from harness import manifest
from harness.judge import judge_samples
from harness.runctx import Run
from reference.stabilizer import Chain


def control(cell, seed: int, seconds: float, rate: float | None, device, dtype=torch.bfloat16) -> dict:
    """The control's verdict on one seed: the cell's driver gives the
    stream inputs, the (stream, input) pairs its run would judge, and the
    map from the reference's YUV to the output format; the reference in
    `dtype` makes the outputs the program would have made."""
    driver = importlib.import_module(f"drivers.{cell.traffic['driver']}")
    inputs, picks, to_output = driver.control_inputs(cell, seed, seconds, rate, device)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=torch.device(device),
              started=time.perf_counter())
    samples = []
    for s, inp in enumerate(inputs):
        low = Chain(cell.config, inp, dtype=dtype, device=device)
        for g, smap in low.maps([g for st, g in picks if st == s]).items():
            px = low.output(g, smap)
            samples.append((s, g, to_output(px) if to_output is not None else px))
    run.attempted = len(samples)
    judge_samples(run, [Chain(cell.config, inp, device=device) for inp in inputs], samples, to_output)
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
        res = control(cell, seed, seconds, args.rate, torch.device(args.device))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
