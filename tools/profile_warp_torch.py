"""Profile of the PyTorch port's warp at 1080p: the whole warps, the dense
map's build and the warp kernel alone, solo and over S streams (the
counterpart of tools/profile_warp.py, tools/profile_warp_batched.py and
tools/profile_easu_serving.py).

Rows, for each filter (EASU, bilinear) and frame type (u8, the delay
queue's; f32), on YUV frames of noise, fill 0:

  * warp.apply 1080p: `WarpField.apply` of the flagship's 2x2 field (its
    exact homography, as tools/profile_stages_torch.py times it);
  * warpfield.apply 1080p: `WarpField.apply` of a 17x30 field (its dense
    map), tools/profile_warp.py's row;
  * homography.warp 1080p: `Homography.warp` of the 2x2 field's homography;
  * warp kernel 1080p: the warp kernel (K1) alone, on that homography's map;
  * S={S} <filter> batched: the stream-axis kernel (K2, one launch) over S
    frames, each by its own similarity (tools/profile_warp_batched.py's
    poses), for S = 1, 2, 4, 8: tools/profile_easu_serving.py's rows;
  * S={S} <filter> lax.map: the same S warps as S solo launches of K1, the
    JAX tool's per-stream map;

and once, the maps alone: homography.sample_map 1080p (the homography's
(2, H, W) map) and warpfield.sample_map 1080p (the 17x30 field's).  The
TPU tools' tile, margin and channel-fusion sweeps and their XLA pre-passes
have no counterpart here.  Each row is the least of --reps runs of --n
replays of its CUDA graph (tools/profile_stages_torch.graph_time); on the
CPU the bodies run the plain versions at a small size.  `profile` is the
function chip_smoke.py calls in-process; `split` reads the warp.apply
split (map build, kernel, the rest) from the rows.

Usage:
    python tools/profile_warp_torch.py [--device cuda|cpu] [--size 1080x1920]
        [--streams 1,2,4,8] [--n 60] [--reps 3] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_stages_torch import graph_time, noise  # noqa: E402
from serving_torch import append, card_line, check_json_out, log, parse_size  # noqa: E402

FILTERS = ("easu", "bilinear")
DTYPES = ("u8", "f32")
STREAMS = (1, 2, 4, 8)
CPU_SIZE = (64, 96)  # --device cpu without --size
FIELD = (17, 30)  # tools/profile_warp.py's WarpField


def _similarities(n_streams: int, size, device):
    """tools/profile_warp_batched.py's poses: stream s scaled by 1 + 0.002
    (s % 3), rotated 0.004 (s - S/2) rad and shifted (7 (s - S/2), -4 s) px."""
    import torch

    import livevisionkit_tpu_torch as lt

    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
    half = n_streams / 2
    return [lt.Homography.from_similarity(f(1.0 + 0.002 * (s % 3)), f(0.004 * (s - half)),
                                          f(7.0 * (s - half)), f(-4.0 * s))
            for s in range(n_streams)]


def frames(n_streams: int, size, dtype: str, device):
    """(S, 3, H, W) noise frames, stream s scaled by 1 + 0.01 s; u8 on the
    0..255 scale."""
    import torch

    pix = noise((3, *size))
    out = torch.stack([pix * (1.0 + 0.01 * s) for s in range(n_streams)]).to(device)
    return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8) if dtype == "u8" else out


def bodies(size=(1080, 1920), device="cuda", streams=STREAMS):
    """(name, filter, dtype, body, state) of each row (the module docstring)."""
    import torch

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.ops import remap

    dev = torch.device(device)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fmt = lt.PixelFormat.YUV
    coarse = lt.WarpField.identity((2, 2), device=dev).offsets + 0.01
    dense = lt.WarpField.identity(FIELD, device=dev).offsets + 0.01
    homography = lt.WarpField(offsets=coarse).to_homography(size)
    smap = homography.sample_map(size).contiguous()
    maps = {s: torch.stack([h.sample_map(size) for h in _similarities(s, size, dev)]).contiguous()
            for s in streams}

    yield ("homography.sample_map 1080p", "-", "f32",
           lambda c, t: (c, lt.Homography(m=homography.m + 1e-9 * t).sample_map(size)), zero)
    yield ("warpfield.sample_map 1080p", "-", "f32",
           lambda c, t: (c, lt.WarpField(offsets=dense + 1e-6 * t).sample_map(size)), zero)
    for filt in FILTERS:
        kw = dict(fill=0.0, filter_mode=filt, fmt=fmt)
        for dtype in DTYPES:
            stack = frames(max(streams), size, dtype, dev)
            pix = stack[0]

            yield ("warp.apply 1080p", filt, dtype,
                   lambda c, t, kw=kw, pix=pix: (
                       c, lt.WarpField(offsets=coarse + 1e-6 * t).apply(pix, **kw)), zero)
            yield ("warpfield.apply 1080p", filt, dtype,
                   lambda c, t, kw=kw, pix=pix: (
                       c, lt.WarpField(offsets=dense + 1e-6 * t).apply(pix, **kw)), zero)
            yield ("homography.warp 1080p", filt, dtype,
                   lambda c, t, kw=kw, pix=pix: (
                       c, lt.Homography(m=homography.m + 1e-9 * t).warp(pix, **kw)), zero)
            yield ("warp kernel 1080p", filt, dtype,
                   lambda c, t, kw=kw, pix=pix: (c, remap.remap(pix, smap, **kw)), zero)
            for s in streams:
                imgs, ms_ = stack[:s], maps[s]
                yield (f"S={s} {filt} batched", filt, dtype,
                       lambda c, t, kw=kw, imgs=imgs, ms_=ms_: (
                           c, torch.func.vmap(lambda im, m: remap.remap(im, m, **kw))(imgs, ms_)),
                       zero)
                yield (f"S={s} {filt} lax.map", filt, dtype,
                       lambda c, t, kw=kw, imgs=imgs, ms_=ms_: (
                           c, [remap.remap(imgs[i], ms_[i], **kw) for i in range(len(imgs))]),
                       zero)


def profile(size=(1080, 1920), device="cuda", n: int = 60, reps: int = 3,
            streams=STREAMS) -> list[dict]:
    """Each row, {"row", "filter", "dtype", "ms"}, in `bodies`' order."""
    return [{"row": name, "filter": filt, "dtype": dtype,
             "ms": graph_time(body, state, n, reps, device=device)}
            for name, filt, dtype, body, state in bodies(size, device, streams)]


def split(rows: list[dict]) -> dict:
    """warp.apply of each (filter, dtype) as its parts, ms: the map
    (homography.warp less the kernel), the kernel, and the rest (the 2x2
    field's homography)."""
    ms = {(r["row"], r["filter"], r["dtype"]): r["ms"] for r in rows}
    out = {}
    for filt in FILTERS:
        for dtype in DTYPES:
            whole = ms[("warp.apply 1080p", filt, dtype)]
            warp = ms[("homography.warp 1080p", filt, dtype)]
            kernel = ms[("warp kernel 1080p", filt, dtype)]
            out[(filt, dtype)] = {"warp.apply": whole, "map": warp - kernel, "kernel": kernel,
                                  "rest": whole - warp}
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="HxW (default 1080x1920; 64x96 on the CPU)")
    ap.add_argument("--streams", default=",".join(map(str, STREAMS)))
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    size = parse_size(args.size) if args.size else (
        CPU_SIZE if args.device == "cpu" else (1080, 1920))
    streams = tuple(int(s) for s in args.streams.split(","))
    card = card_line(args.device)
    log(f"profile_warp on {card}, {size[0]}x{size[1]}, S in {streams}")
    rows = profile(size, args.device, args.n, args.reps, streams)
    for r in rows:
        print(f"{r['row'] + ':':30s}{r['ms']:8.4f} ms  ({r['filter']}, {r['dtype']})", flush=True)
        append({"tool": "profile_warp", **r, "device": card, "size": f"{size[0]}x{size[1]}"},
               args.json_out)
    for (filt, dtype), parts in split(rows).items():
        print(f"warp.apply split ({filt}, {dtype}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()) + " ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
