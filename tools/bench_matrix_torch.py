"""Config ladder of the PyTorch port: the BASELINE.md workload matrix on
one card (the counterpart of tools/bench_matrix.py).

The JAX tool's 14 configs, with its names, settings and frame sizes: the
640x480 GRAY stabilizer (240x320 detection, a 12x16 grid, 128
hypotheses, min_samples 30), the 1080p and 4K homography and mesh
stabilizers with the EASU warp and with `warp_filter="bilinear"`, the
deblocker at 1080p and 4K, the 1080p -> 4K EASU + RCAS scaler, CAS at 4K,
and the 4K mesh stabilizer + deblocker + CAS as one `CompositeFilter`
step.  Each config's step takes a frame of noise plus 1e-9 t, stamped
t / 60, and is timed as a replayed CUDA graph
(tools/profile_stages_torch.graph_time: CUDA events over back-to-back
replays from an idle card, the least of --reps runs of --n); on the CPU
(--device cpu) it is called as it is and timed by the host clock.  Each
config's graph and memory are released before the next.

`matrix` is the function chip_smoke.py calls in-process; it yields each
row as it is measured.  Rows go to stdout as the JAX tool's JSON lines,
{"config", "value", "unit"}; --json-out appends them (never to a BENCH_*
file).

Usage:
    python tools/bench_matrix_torch.py [--device cuda|cpu] [--only SUBSTR] [--n 60]
        [--reps 3] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_stages_torch import graph_time  # noqa: E402
from serving_torch import card_line, check_json_out, emit, log  # noqa: E402


def configs() -> list[tuple]:
    """(name, filter, channels, height, width, format) of each config, in
    the JAX tool's order (tools/bench_matrix.py:79-156)."""
    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch import presets

    yuv, gray = lt.PixelFormat.YUV, lt.PixelFormat.GRAY
    mesh = presets.stabilization_preset(model="field")

    def mesh_filter(**changes):
        return lt.StabilizationFilter(settings=dataclasses.replace(mesh, **changes))

    return [
        ("640x480_gray_stabilization",
         lt.flagship_filter(detection=(240, 320), grid=(12, 16), min_samples=30, hypotheses=128),
         1, 480, 640, gray),
        ("1080p_homography_stabilization", lt.flagship_filter(), 3, 1080, 1920, yuv),
        ("1080p_homography_stabilization_bilinear", lt.flagship_filter(warp_filter="bilinear"),
         3, 1080, 1920, yuv),
        ("1080p_mesh_stabilization", mesh_filter(), 3, 1080, 1920, yuv),
        ("1080p_mesh_stabilization_bilinear", mesh_filter(warp_filter="bilinear"),
         3, 1080, 1920, yuv),
        ("1080p_deblock", lt.DeblockingFilter(settings=lt.DeblockingFilterSettings()),
         3, 1080, 1920, yuv),
        ("1080p_to_4k_easu_rcas",
         lt.ScalingFilter(settings=lt.ScalingFilterSettings(output_size=(2160, 3840))),
         3, 1080, 1920, yuv),
        ("4k_homography_stabilization", lt.flagship_filter(), 3, 2160, 3840, yuv),
        ("4k_homography_stabilization_bilinear", lt.flagship_filter(warp_filter="bilinear"),
         3, 2160, 3840, yuv),
        ("4k_mesh_stabilization", mesh_filter(), 3, 2160, 3840, yuv),
        ("4k_mesh_stabilization_bilinear", mesh_filter(warp_filter="bilinear"),
         3, 2160, 3840, yuv),
        ("4k_deblock", lt.DeblockingFilter(settings=lt.DeblockingFilterSettings()),
         3, 2160, 3840, yuv),
        ("4k_cas", lt.CASFilter(settings=lt.CASFilterSettings()), 3, 2160, 3840, yuv),
        # The one-step 4K chain (reference CompositeFilter.cpp:60-88),
        # against the 16.6 ms 4K60 frame budget.
        ("4k_full_chain_fused",
         lt.CompositeFilter(filters=(lt.StabilizationFilter(settings=mesh),
                                     lt.DeblockingFilter(settings=lt.DeblockingFilterSettings()),
                                     lt.CASFilter(settings=lt.CASFilterSettings()))),
         3, 2160, 3840, yuv),
    ]


def body_and_state(filt, c: int, h: int, w: int, fmt, pix):
    """A config's step body on `pix` (its (c, h, w) frame on the device)
    and its initial state."""
    import torch

    import livevisionkit_tpu_torch as lt

    live = torch.ones((), dtype=torch.bool, device=pix.device)

    def body(st, t):
        return filt.step(st, lt.Frame(pixels=pix + 1e-9 * t, timestamp=t / 60.0, valid=live,
                                      format=fmt))

    return body, filt.init(lt.FrameSpec(h, w, c, fmt), device=pix.device)


def matrix(only: str | None = None, device="cuda", n: int = 60, reps: int = 3):
    """One row per config whose name holds `only` (every config when
    None), yielded as measured."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    for name, filt, c, h, w, fmt in configs():
        if only and only not in name:
            continue
        pix = torch.from_numpy(rng.uniform(0.1, 0.9, size=(c, h, w)).astype(np.float32)).to(device)
        body, state = body_and_state(filt, c, h, w, fmt, pix)
        log(f"{name}: capture + {reps} x {n} replays ...")
        ms = graph_time(body, state, n, reps, device=pix.device)
        del body, state, pix
        yield {"config": name, "value": ms, "unit": "ms/frame/chip"}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=None, help="run only configs whose name contains SUBSTR")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    ap.add_argument("--json-out", default=None, help="also append result lines to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    log(f"bench_matrix on {card_line(args.device)}")
    return [emit(row, args.json_out) for row in matrix(args.only, args.device, args.n, args.reps)]


if __name__ == "__main__":
    main()
