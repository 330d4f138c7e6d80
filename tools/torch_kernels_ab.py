"""Time the port's kernels against other versions', alternated in one
process on one CUDA card.

    python3 tools/torch_kernels_ab.py --other NAME=DIR [--other NAME=DIR ...] [--runs 30]
        [--cases K3,K6] [--out FILE]

Each DIR holds another version's `livevisionkit_tpu_torch/csrc/` sources
(for example `git archive <commit> livevisionkit_tpu_torch/csrc`
unpacked into a git-ignored directory); every version exports the C
entry points `lvk_warp`, `lvk_easu_scale`, `lvk_rcas` and `lvk_lk_track`
(or, since the restaged count, `lvk_lk_track_counted`;
ops/cuda_kernels/lk.launch calls either). A version is built into
build/ab_NAME/ with the package's own build (`build.library`), this
checkout's kernels as usual. Each case runs every version in turn, then
again in reverse order, under two timers: CUDA-event medians of `runs`
single launches behind a device spin (chip_smoke._median_ms, the kernels
line's timer) and without it (the timer before the spin, whose times
also hold the host's enqueue gap). The cases are chip_smoke.py's inputs:
the EASU warp solo (u8 3x1080x1920) and over 8 streams, the same for the
bilinear mode, the bilinear mode on a u8 3x2160x3840 frame and on an f32
1080p frame under lens correction's undistort map, the EASU upscale
(f32, 1080p -> 4K and 720p -> 1080p), LK solo (3 levels of 272x480, 510
features), over 8 streams and with one level (K4), and RCAS at
3x2160x3840; `--cases` keeps those whose name
holds one of the given words. It also prints how far each version's
outputs are from this checkout's, and two floors under the same timers:
an empty kernel (this checkout's `lvk_noop`) and a `torch.clone` of the
RCAS frame. One JSON line per case, and all of them to --out.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its inputs and timer)
import livevisionkit_tpu_torch as lvk  # noqa: E402
from livevisionkit_tpu_torch.config import OpticalFlowSettings  # noqa: E402
from livevisionkit_tpu_torch.ops import easu as easu_ops  # noqa: E402
from livevisionkit_tpu_torch.ops.cuda_kernels import build  # noqa: E402
from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel  # noqa: E402


def _print_resources(label: str, log: Path) -> None:
    for r in build.resources(log):
        print(f"{label}: {r['kernel']}: {r['registers']} registers, {r['smem']} B static shared "
              f"memory, {r['spill_stores']} / {r['spill_loads']} B spilled", flush=True)


def _warp(lib, imgs, maps, easu: bool) -> torch.Tensor:
    """One launch of lib's warp over the (S, C, H, W) frames and (S, 2, H, W) maps, fill 0, YUV."""
    n, c, h, w = imgs.shape
    out = torch.empty_like(imgs)
    status = lib.lvk_warp(imgs.data_ptr(), maps.data_ptr(), out.data_ptr(), n, imgs.stride(0),
                          maps.stride(0), c, h, w, h, w, int(imgs.dtype == torch.uint8), int(easu),
                          1, 0.0, 0, torch.cuda.current_stream().cuda_stream)
    assert status == 0, f"warp launch failed: {status}"
    return out


def _scale(lib, img, size) -> torch.Tensor:
    c, h, w = img.shape
    plan = easu_ops.scale_plan((h, w), size)
    out = torch.empty((c, *size), dtype=torch.float32, device=img.device)
    status = lib.lvk_easu_scale(img.data_ptr(), out.data_ptr(), c, h, w, *size, int(plan.rational),
                                plan.py, plan.qy, plan.px, plan.qx, h / size[0], w / size[1], 0,
                                torch.cuda.current_stream().cuda_stream)
    assert status == 0, f"easu_scale launch failed: {status}"
    return out


def _lk(lib, prev, nxt, pts, flow0) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of lib's LK over the levels (S, H_l, W_l) or (H_l, W_l)
    and (S, N, 2) or (N, 2) points and initial flow, with the flagship's
    window, iterations and threshold: the flow and the status."""
    s = OpticalFlowSettings()
    n_streams, n = (pts.shape[0], pts.shape[1]) if pts.ndim == 3 else (1, pts.shape[0])
    flow = torch.empty((n_streams, n, 2), device=pts.device)
    good = torch.empty((n_streams, n), dtype=torch.bool, device=pts.device)
    status = lk_kernel.launch(lib, prev, nxt, pts, flow0, flow, good, s.window_size,
                              s.iterations, s.min_eigen_threshold)
    assert status == 0, f"lk_track launch failed: {status}"
    return flow, good


def _rcas(lib, img) -> torch.Tensor:
    c, h, w = img.shape
    out = torch.empty_like(img)
    status = lib.lvk_rcas(img.data_ptr(), out.data_ptr(), c, h, w, 0.8,
                          torch.cuda.current_stream().cuda_stream)
    assert status == 0, f"rcas launch failed: {status}"
    return out


def _apart(a, b) -> str:
    """How far output(s) a are from b: a tensor or a tuple of tensors."""
    if isinstance(a, tuple):
        a, b = (torch.cat([t.flatten().float() for t in x]) for x in (a, b))
    d = (a.float() - b.float()).abs()
    return f"max {float(d.max()):.3e} on {float((d > 0).float().mean()):.2e} of outputs"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--cases", default=None, metavar="WORD,WORD",
                    help="run only the cases whose name holds one of these words")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = chip_smoke._gpu_line()
    print(f"gpu: {gpu}", flush=True)
    libs = {}
    for spec in args.other:
        name, _, src = spec.partition("=")
        out_dir = ROOT / "build" / f"ab_{name}"
        libs[name] = build.library(Path(src).resolve(), out_dir)
        _print_resources(name, out_dir / build.PTXAS_LOG.name)
    libs["this"] = build.library()
    _print_resources("this", build.PTXAS_LOG)

    rng = np.random.default_rng(0)
    H, W, S = chip_smoke.H, chip_smoke.W, chip_smoke.STREAMS
    luma = torch.from_numpy(chip_smoke._texture(H, W, rng)).to(dev)
    base = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)])
    frames_f = torch.stack([torch.roll(base, (37 * s, 61 * s), dims=(1, 2)) for s in range(S)])
    frames_u8 = torch.clamp(frames_f * 255.0 + 0.5, 0, 255).to(torch.uint8).contiguous()
    sims = [(1.0 + 0.004 * s, math.radians(0.25 * (s - 3)), 6.0 * s - 20.0, 9.0 - 3.0 * s)
            for s in range(S)]
    maps = torch.stack([chip_smoke._similarity(*p, dev).sample_map((H, W)) for p in sims]).contiguous()
    small = torch.from_numpy(chip_smoke._texture(720, 1280, rng)).to(dev)
    small = torch.stack([small, 0.25 + 0.5 * small.flip(0), 0.75 - 0.5 * small.flip(1)]).contiguous()
    cases = {
        "K1 warp EASU u8 3x1080x1920": lambda lib: _warp(lib, frames_u8[:1], maps[:1], True),
        f"K2 warp EASU u8 {S}x3x1080x1920": lambda lib: _warp(lib, frames_u8, maps, True),
        "K1 warp bilinear u8 3x1080x1920": lambda lib: _warp(lib, frames_u8[:1], maps[:1], False),
        f"K2 warp bilinear u8 {S}x3x1080x1920": lambda lib: _warp(lib, frames_u8, maps, False),
        "K5 easu_scale f32 3x1080x1920 -> 3x2160x3840": lambda lib: _scale(
            lib, base.contiguous(), (2160, 3840)),
        "K5 easu_scale f32 3x720x1280 -> 3x1080x1920": lambda lib: _scale(lib, small, (H, W)),
    }
    prev, nxt, pts, _ = chip_smoke.lk_inputs(dev, rng)
    prev_b, nxt_b, pts_b, _ = chip_smoke.lk_batched_inputs(dev, rng)
    zero, zero_b = torch.zeros_like(pts), torch.zeros_like(pts_b)
    frame_4k = chip_smoke.rcas_input(dev, rng)
    # The 4K stabilizer's bilinear u8 warp and lens correction's bilinear
    # f32 warp (chip_smoke.check_warp_ladder's and check_lens_correction's
    # inputs).
    uhd = chip_smoke.OUT
    luma_4k = torch.from_numpy(chip_smoke._texture(*uhd, rng)).to(dev)
    frame_4k_u8 = torch.stack([luma_4k, 0.25 + 0.5 * luma_4k.flip(0), 0.75 - 0.5 * luma_4k.flip(1)])
    frame_4k_u8 = torch.clamp(frame_4k_u8 * 255.0 + 0.5, 0, 255).to(torch.uint8)[None].contiguous()
    k = uhd[0] / H
    map_4k = chip_smoke._similarity(1.01, math.radians(0.5), 12.0 * k, -7.0 * k, dev).sample_map(
        uhd)[None].contiguous()
    lc = lvk.LensCorrectionFilter(parameters=lvk.CameraParameters(**chip_smoke.CAMERA),
                                  warp_filter="bilinear")
    lc_map = lc.init(lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV), device=dev).sample_map((H, W))
    lc_map = lc_map[None].contiguous()
    cases.update({
        "K3 lk_track 3 levels of 272x480, 510 features": lambda lib: _lk(lib, prev, nxt, pts, zero),
        f"K3 lk_track {S} streams x 3 levels of 272x480, {S}x510 features": lambda lib: _lk(
            lib, prev_b, nxt_b, pts_b, zero_b),
        "K4 lk_level (K3, n_levels = 1) 272x480, 510 features": lambda lib: _lk(
            lib, prev[:1], nxt[:1], pts, zero),
        "K6 rcas f32 3x2160x3840": lambda lib: _rcas(lib, frame_4k),
        "K1 warp bilinear u8 3x2160x3840": lambda lib: _warp(lib, frame_4k_u8, map_4k, False),
        "K1 warp bilinear f32 3x1080x1920 on lens correction's undistort map": lambda lib: _warp(
            lib, base[None].contiguous(), lc_map, False),
    })
    if args.cases:
        words = args.cases.split(",")
        cases = {k: v for k, v in cases.items() if any(w in k for w in words)}
    noop = lambda: libs["this"].lvk_noop(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    floors = {"case": "floors", "gpu": gpu, "runs": args.runs}
    for timer, spin in (("ms", True), ("ms_no_spin", False)):
        floors[timer] = {"empty kernel": chip_smoke._median_ms(noop, args.runs, spin=spin),
                         "torch.clone 3x2160x3840 f32": chip_smoke._median_ms(
                             frame_4k.clone, args.runs, spin=spin)}
    print(json.dumps(floors), flush=True)
    results = [floors]
    for name, call in cases.items():
        want = call(libs["this"])
        apart = {k: _apart(call(lib), want) for k, lib in libs.items() if k != "this"}
        row = {"case": name, "apart": apart, "gpu": gpu, "runs": args.runs}
        for timer, spin in (("ms", True), ("ms_no_spin", False)):
            times = {k: [] for k in libs}
            for k in [*libs, *reversed(libs)]:
                times[k].append(chip_smoke._median_ms(lambda: call(libs[k]), args.runs, spin=spin))
            row[timer] = times
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
