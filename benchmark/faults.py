"""Faults planted in the program under runs of a cell: what `correct`
compares when the timed path is broken underneath, read at the cell's own
size (the faults' readings in PERF.md), and the faults the CPU tests plant.

    python3 benchmark/faults.py --workload <name> --fault <fault> --seeds 11 12 13 [--seconds 10]

runs the cell once a seed in one process, with the fault planted in the
port before its filter is built, and prints for each seed one JSON line:
the fault, the seed, `correct`, `failed` and each compared number with its
limit.  `--fault none` reads sound runs (the lower readings).  The
benchmark's own runs never plant a fault.

  none             the program as it is
  state_unchanged  the stabilizer's step returns the state it was given
  still_tracker    the tracker reports no motion, every frame
  no_deblocking    the deblocker passes its frame through unchanged
  no_cas           CAS passes its frame through unchanged
  moved            the stabilizer's output moved 4 pixels to the right
  brightened       the stabilizer's output 8 levels brighter
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from typing import Callable

import run as bench


def _stabilizer():
    from livevisionkit_tpu_torch.filters.stabilization import StabilizationFilter

    return StabilizationFilter


def _state_unchanged(patch: Callable) -> None:
    cls = _stabilizer()
    step = cls.step

    def frozen(self, state, frame, **kw):
        return state, step(self, state, frame, **kw)[1]

    patch(cls, "step", frozen)


def _altered(change: Callable) -> Callable:
    def plant(patch: Callable) -> None:
        cls = _stabilizer()
        step = cls.step

        def altered(self, state, frame, **kw):
            state, out = step(self, state, frame, **kw)
            return state, dataclasses.replace(out, pixels=change(out.pixels))

        patch(cls, "step", altered)

    return plant


def _still_tracker(patch: Callable) -> None:
    import torch

    from livevisionkit_tpu_torch.vision import frame_tracker

    track = frame_tracker.track

    def still(state, gray, settings):
        state, result = track(state, gray, settings)
        motion = dataclasses.replace(result.motion, offsets=torch.zeros_like(result.motion.offsets))
        return state, dataclasses.replace(result, motion=motion)

    patch(frame_tracker, "track", still)


def _pass_through(class_name: str) -> Callable:
    def plant(patch: Callable) -> None:
        import livevisionkit_tpu_torch as lvk

        patch(getattr(lvk, class_name), "step", lambda self, state, frame, **kw: (state, frame))

    return plant


FAULTS: dict[str, Callable] = {
    "none": lambda patch: None,
    "state_unchanged": _state_unchanged,
    "still_tracker": _still_tracker,
    "no_deblocking": _pass_through("DeblockingFilter"),
    "no_cas": _pass_through("CASFilter"),
    "moved": _altered(lambda px: px.roll(4, dims=-1)),
    "brightened": _altered(lambda px: px + 8.0 / 255.0),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    bench.cache_env()
    sys.path.insert(1, str(bench.ROOT))
    from harness import manifest

    import torch

    cell = manifest.cell(args.workload)
    seconds = args.seconds if args.seconds is not None else manifest.load_manifest()["run_seconds"]
    FAULTS[args.fault](setattr)
    for seed in args.seeds:
        res = bench.execute(cell, seed, seconds, False, args.device)
        print(json.dumps({"fault": args.fault, "seed": seed, "correct": res["correct"],
                          "failed": res["failed"], "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
