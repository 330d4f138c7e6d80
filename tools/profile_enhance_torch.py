"""Stage-level latency profile of the PyTorch port's enhancement filters,
the deblocker, the EASU upscale and RCAS (the counterpart of
tools/profile_enhance.py).

Rows, under the JAX tool's names, on a 1080p YUV frame of noise: the
deblocker's stages on its 16-aligned crop (the 1/4 average pool, the 5x5
median at 270p, K8's median kernel on the card, the 4x linear upsample,
the blockiness measure of the luma and its pools, and the whole filter
body of plain stages: keep map, smoothed frame and blend; the filter
itself runs K8's two kernels), the EASU scale 1080p -> 4K (K5), RCAS at 4K (K6) on a
linear 2x upsample, and EASU + RCAS in one body.  --size shrinks the
input for CPU runs (the 2x output follows; the names stay).  Timing:
tools/profile_stages_torch.graph_time.  `enhance` is the function
chip_smoke.py calls in-process.

Usage:
    python tools/profile_enhance_torch.py [--device cuda|cpu] [--size 1080x1920]
        [--n 60] [--reps 3] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_stages_torch import noise, time_rows  # noqa: E402
from serving_torch import append, card_line, check_json_out, log, parse_size  # noqa: E402

BLOCK, SCALING, KSIZE = 16, 4, 5  # the deblocker's macroblock, pooling factor and median size
SHARPNESS = 0.8


def bodies(size: tuple[int, int] = (1080, 1920), device="cuda"):
    """(name, body, state) of each row (the module docstring)."""
    import torch

    from livevisionkit_tpu_torch.ops import color, easu, rcas, resample
    from livevisionkit_tpu_torch.types import PixelFormat

    h, w = size
    fmt = PixelFormat.YUV
    px = noise((3, h, w)).to(device)
    pxc = px[:, :(h // BLOCK) * BLOCK, :(w // BLOCK) * BLOCK]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    small0 = resample.avg_pool(pxc, SCALING)
    gray0 = color.luma(pxc, fmt)

    def measure(gray):
        bm = resample.avg_pool(gray, BLOCK)
        ref = resample.upsample_nearest_int(bm, BLOCK)
        return resample.avg_pool((gray - ref).abs(), BLOCK)

    def keep_blend(c, t):
        m = measure(gray0 + 1e-9 * t)
        keep_blocks = torch.clamp(torch.floor(m * 255.0), max=3.0) / 3.0
        keep = resample.upsample_linear_int(keep_blocks, (BLOCK, BLOCK))
        small = resample.median_blur(resample.avg_pool(pxc + 1e-9 * t, SCALING), KSIZE)
        smooth = resample.upsample_linear_int(small, (SCALING, SCALING))
        return c, pxc * keep[None] + smooth * (1.0 - keep[None])

    yield ("deblock.avg_pool(1/4)",
           lambda c, t: (c, resample.avg_pool(pxc + 1e-9 * t, SCALING)), zero)
    yield ("deblock.median5@270p",
           lambda c, t: (c, resample.median_blur(small0 + 1e-9 * t, KSIZE)), zero)
    yield ("deblock.up_linear(4x)",
           lambda c, t: (c, resample.upsample_linear_int(small0 + 1e-9 * t, (SCALING, SCALING))),
           zero)
    yield "deblock.measure(luma+pools)", lambda c, t: (c, measure(gray0 + 1e-9 * t)), zero
    yield "deblock.full-fused", keep_blend, zero

    out_size = (2 * h, 2 * w)
    yield ("easu_scale 1080p->4K",
           lambda c, t: (c, easu.easu_scale(px + 1e-9 * t, out_size, fmt=fmt)), zero)
    up0 = resample.upsample_linear_int(px, (2, 2))
    yield "rcas@4K", lambda c, t: (c, rcas.rcas(up0 + 1e-9 * t, SHARPNESS)), zero
    yield ("easu+rcas fused",
           lambda c, t: (c, rcas.rcas(easu.easu_scale(px + 1e-9 * t, out_size, fmt=fmt), SHARPNESS)),
           zero)


def enhance(size: tuple[int, int] = (1080, 1920), device="cuda", n: int = 60,
            reps: int = 3) -> list[tuple[str, float]]:
    """The rows, (name, ms) in the JAX tool's order."""
    return time_rows(bodies(size, device), n, reps)


def main(argv=None) -> list[tuple[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    size = parse_size(args.size)
    card = card_line(args.device)
    log(f"profile_enhance on {card}, {size[0]}x{size[1]}")
    rows = enhance(size, args.device, args.n, args.reps)
    for name, ms in rows:
        print(f"{name:34s} {ms:7.3f} ms", flush=True)
        append({"tool": "profile_enhance", "row": name, "ms": ms, "device": card,
                "size": f"{size[0]}x{size[1]}"}, args.json_out)
    return rows


if __name__ == "__main__":
    main()
