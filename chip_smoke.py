"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written kernels from csrc/ (printing each one's registers,
shared memory and spills from ptxas), holds each against its plain
PyTorch version on the card at the shapes of the main paths (the warp
solo and batched over 8 streams, also under maps whose blocks exceed the
warp's shared-memory box, LK solo, over 8 streams and with one level,
which is K4, the EASU upscale and RCAS solo and over 8 streams at the
chain tick's 1080p -> 4K shapes, each batched launch bit-equal to 8 solo
launches and to them at stream stride 0, RCAS beside a clone of its
frame, and an empty kernel as the floor of every launch's time), then
drives the paths over synthetic shaky 1080p clips rendered on the card:
the flagship stabilizer (`livevisionkit_tpu_torch.flagship_filter`)
alone; 8 streams of it in one batched step (`MultiStreamFilter`),
alternated twice with the solo stabilizer; the chain stabilizer -> FSR
scaler to 4K (`CompositeFilter` of it and `ScalingFilter`), solo and over
8 streams; the stabilizer in mesh mode
(`presets.stabilization_preset(model="field")`, a 16x16 mesh), solo, with
the warp kernel checked on its dense sample map, and over 8 streams; and
the multi-stream driver `stream_multi` over 8 in-memory 1080p BGR readers.
Each drive checks that its step went through its kernels once per frame
(or tick) and that the outputs are right.  It also times the scaler alone
at 1080p -> 4K.  Every failure raises.  The last line is a JSON object
with the device; the line before it gives the card's name and power limit
and each path's ms per step, and the line before that lists each kernel's
launches over every path, error and times, with its bound (the larger of
its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, the H100
SXM's published peaks, counted from this run's shapes and maps) and the
time of one PyTorch call computing the same function where there is one
(none computes EASU, LK or RCAS).  Kernel times are taken behind a device
spin, so the host's enqueue gap is not in them; the text lines give each
also without the spin, as timed before.  With no CUDA device it exits
non-zero and prints no result.  `--profile DIR` also writes
torch.profiler tables of five steady steps of each path to DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 1080, 1920
OUT = (2160, 3840)  # the chain's 4K output
# K5 cases: the chain's 2x, the reference scaler's default output from 720p
# (a 3/2 ratio, config.py's ScalingFilterSettings), 4/3 from 810p, one
# fallback ratio and a 0.5x downscale (whose tiles gather from device memory).
SCALE_CASES = (((H, W), OUT), ((720, 1280), (H, W)), ((810, 1440), (H, W)),
               ((H, W), (1600, 2844)), ((H, W), (540, 960)))
# The H100 SXM's published peaks (NVIDIA data sheet, at its 700 W limit).
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
N_FRAMES, N_TIMED = 60, 40
RUNS = 20
STREAMS = 8  # the multi-stream paths: 8 x 1080p, the JAX package's serving config
DRIVER_FRAMES = 30  # frames per stream through `stream_multi`
MESH_TICKS = 30  # ticks of the 8-stream mesh phase (its step is the longest)


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _nvcc_line() -> str:
    from livevisionkit_tpu_torch.ops.cuda_kernels import build

    out = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    return [ln for ln in out.splitlines() if "release" in ln][-1].strip()


def _median_ms(fn, runs: int = RUNS, spin: bool = True) -> float:
    """Median of `runs` CUDA-event timings of fn() after one warm-up call.
    With `spin` the device first spins for ~0.5 ms, so the host has queued
    fn's launches before the device reaches them: a time is the device's
    own.  Without it (the timer of the kernels line before the spin was
    added) a time also holds the host's enqueue gap between the first event
    and the launch, a few tens of us."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the f32 operations over the f32 rate."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _easu_ops(n_out: int, n_src: int, nc: int) -> int:
    """f32 operations of n_out EASU outputs of nc channels (luma = plane 0)
    whose bilinear corners are n_src distinct source pixels, counted one
    per add, sub, mul, div, min, max, abs, compare, select and rsqrt in the
    plain version (ops/easu._easu_core).  A corner's direction terms (27:
    two luma differences across it, each with a division) depend on its
    source pixel alone, so they are counted once per pixel; per output, the
    blend of its four corners' terms (30), kernel shaping (44), the 12
    weighted taps (21 + 2 per channel each), the de-ring window (6 per
    channel) and the normalisation (4 + 3 per channel).  A nearest or fill
    output costs none."""
    return 27 * n_src + n_out * (30 + 44 + 12 * (21 + 2 * nc) + 6 * nc + 4 + 3 * nc)


def _easu_work(smap: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(outputs, corner pixels) of a (2, H', W') or (S, 2, H', W') map over
    (h, w) sources: the outputs whose 4x4 EASU support lies inside, and the
    source pixels that are a bilinear corner f, g, j or k of one of them,
    summed over the maps."""
    n_out = n_src = 0
    for m in smap.reshape(-1, *smap.shape[-3:]):
        y0, x0 = torch.floor(m[0]).long(), torch.floor(m[1]).long()
        ok = (x0 >= 1) & (y0 >= 1) & (x0 < w - 4) & (y0 < h - 4)
        f = (y0 * w + x0)[ok]
        corner = torch.zeros(h * w, dtype=torch.bool, device=m.device)
        for d in (0, 1, w, w + 1):
            corner[f + d] = True
        n_out += int(ok.sum())
        n_src += int(corner.sum())
    return n_out, n_src


def _lk_ops(n_feat: int, n_levels: int, win: int, iters: int) -> int:
    """f32 operations of the LK kernel (csrc/lk.cu), which runs every
    feature through every level and iteration: per level the (win+2)^2
    template samples (9 each), per window pixel the Scharr gradients and
    the gradient matrix (28), ~15 for the eigenvalue test, and per
    iteration 14 per window pixel (sample, residual, two products) and ~10
    for the step."""
    area = win * win
    per_level = (win + 2) ** 2 * 9 + 28 * area + 15 + iters * (14 * area + 10)
    return n_feat * n_levels * per_level


def _rcas_ops(nc: int, h: int, w: int) -> int:
    """f32 operations of RCAS (csrc/rcas.cu): 25 per channel and 6 per
    pixel inside the one-pixel border, which is copied."""
    return (25 * nc + 6) * (h - 2) * (w - 2)


def _affine_map(size, scale: float, angle: float, dev) -> torch.Tensor:
    """(2, H, W) map taking output pixel u to scale * R(angle) (u - c) + c
    about the centre c: scale 2 is a 0.5x zoom-out."""
    h, w = size
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev) - (h - 1) / 2,
                            torch.arange(w, dtype=torch.float64, device=dev) - (w - 1) / 2,
                            indexing="ij")
    co, si = math.cos(angle) * scale, math.sin(angle) * scale
    return torch.stack([si * xx + co * yy + (h - 1) / 2,
                        co * xx - si * yy + (w - 1) / 2]).float().contiguous()


# Maps whose blocks spread over more source pixels than the EASU warp's
# shared-memory box holds, so they take its device-memory path.
OVERFLOW_MAPS = {"zoom-out 0.5x": (2.0, 0.0), "rotation 30 deg": (1.0, math.radians(30.0))}


def _paths(launch, dev) -> tuple[int, int]:
    """(blocks holding an EASU sample, blocks of them whose source box
    exceeds the shared-memory box and which gather from device memory), as
    the warp kernel counts them in `launch(counts)`."""
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    launch(counts)
    used, over = counts.tolist()
    return used, over


def _u8_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def _texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Feature-rich gray texture in [0, 1]: blurred noise + bright/dark squares."""
    img = rng.uniform(0.2, 0.5, size=(h, w)).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    for _ in range((h * w) // 2500):
        y, x = rng.integers(0, h - 48), rng.integers(0, w - 48)
        s = int(rng.integers(12, 48))
        img[y:y + s, x:x + s] = rng.uniform(0.75, 1.0) if rng.uniform() > 0.5 else rng.uniform(0.0, 0.1)
    return img


def _similarity(scale, angle, tx, ty, dev):
    from livevisionkit_tpu_torch import Homography

    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    return Homography.from_similarity(f(scale), f(angle), f(tx), f(ty))


def _counters():
    """Each kernel's launch count: its wrapper and the attribute the wrapper
    adds one to where it launches (K4 is K3's one-level call, counted apart;
    K3's stream axis is the same wrapper, counted by the path that calls it)."""
    from livevisionkit_tpu_torch.ops.cuda_kernels import easu_scale, lk, rcas, warp

    return {"warp": (warp.warp, "launches"), "warp_batched": (warp.warp_batched, "launches"),
            "lk_track": (lk.lk_track, "launches"), "lk_level": (lk.lk_track, "launches_one_level"),
            "easu_scale": (easu_scale.easu_scale, "launches"),
            "easu_scale_batched": (easu_scale.easu_scale_batched, "launches"),
            "rcas": (rcas.rcas, "launches"), "rcas_batched": (rcas.rcas_batched, "launches")}


def _want(**launches) -> dict:
    """Every kernel's expected launch count: those named, the rest 0."""
    return {name: launches.get(name, 0) for name in _counters()}


def _reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _shaky_render(dev, rng):
    """A 60-frame 1080p YUV shaky camera path over a texture larger than
    the frame: slow drift + per-frame jitter (px, rad).  Returns the frame
    -> texture poses and a function rendering frame t's (3, H, W) pixels."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops

    tex = torch.from_numpy(_texture(H + 320, W + 320, rng)).to(dev)[None].contiguous()
    n = N_FRAMES
    tx = 100.0 + 1.0 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ty = 100.0 + 0.5 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ang = rng.uniform(-0.003, 0.003, n)
    poses = [_similarity(1.0, ang[t], tx[t], ty[t], dev) for t in range(n)]

    def pixels(t):
        y = remap_ops.remap(tex, poses[t].sample_map((H, W), inverse=False), fill=0.5,
                            filter_mode="bilinear")
        return torch.cat([y, torch.full((2, H, W), 0.5, device=dev)]).contiguous()

    return poses, pixels


def _shaky_clip(dev, rng):
    """The frames of `_shaky_render`'s path, f32 YUV, and its poses."""
    import livevisionkit_tpu_torch as lvk

    poses, pixels = _shaky_render(dev, rng)
    frames = [lvk.Frame.create(pixels(t), timestamp=t / 30.0, fmt=lvk.PixelFormat.YUV)
              for t in range(N_FRAMES)]
    torch.cuda.synchronize()
    return poses, frames


def _shaky_clips_u8(dev, rng):
    """STREAMS shaky clips, each over its own texture and path, kept as u8
    YUV on the card: the poses per stream and a (STREAMS, 60, 3, H, W) u8
    tensor (3 GB where 480 f32 frames would take 12 GB)."""
    poses, clips = [], torch.empty((STREAMS, N_FRAMES, 3, H, W), dtype=torch.uint8, device=dev)
    for s in range(STREAMS):
        ps, pixels = _shaky_render(dev, rng)
        poses.append(ps)
        for t in range(N_FRAMES):
            clips[s, t] = torch.clamp(pixels(t) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    torch.cuda.synchronize()
    return poses, clips


def _profile(step, state, frames, path: str) -> None:
    """torch.profiler table and trace of five steady steps, and a line with
    the kernel launches and device busy time per step and the idle share of
    the traced span (first kernel start to last kernel end)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    steps = frames[:5]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fr in steps:
            state, _ = step(state, fr)
        torch.cuda.synchronize()
    with open(path + "_profile.txt", "w") as fh:
        fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    prof.export_chrome_trace(path + "_trace.json")
    with open(path + "_trace.json") as fh:
        kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.load(fh)["traceEvents"]
                         if e.get("cat") == "kernel")
    if not kernels:
        print(f"profile {os.path.basename(path)}: no device kernels traced", flush=True)
        return
    busy, end = 0.0, kernels[0][0]
    for start, stop in kernels:  # union of the kernel intervals, in us
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - kernels[0][0]
    n = len(steps)
    print(f"profile {os.path.basename(path)}: {len(kernels) / n:.1f} kernel launches per step, "
          f"{busy / n / 1e3:.4f} ms device busy per step, {100.0 * (1.0 - busy / span):.1f}% of "
          f"the traced span idle", flush=True)


def check_warp(dev, rng) -> dict:
    """K1 against its plain version at 1080x1920x3 under a stabilization-
    scale similarity whose corner leaves the frame (fill + nearest ring),
    then under the overflowing maps; the bilinear mode beside
    F.grid_sample, its one-call PyTorch counterpart inside the frame."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    img_f = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
    img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.01, math.radians(0.5), 12.0, -7.0, dev).sample_map((H, W)).contiguous()
    n_out = float(((smap[0] < 0) | (smap[0] > H - 1) | (smap[1] < 0) | (smap[1] > W - 1)).sum())
    assert n_out > 1000, f"the map must leave the frame somewhere ({n_out} px do)"
    used, over = _paths(lambda c: warp_kernel.warp(img_u8, smap, block_paths=c), dev)
    assert over == 0, f"{over} of {used} blocks of the stabilization map overflow the box"
    report = {}
    for mode in ("easu", "bilinear"):
        kf = warp_kernel.warp(img_f, smap, fill=0.0, filter_mode=mode)
        pf = remap_ops.remap_plain(img_f, smap, fill=0.0, filter_mode=mode)
        err_f = float((kf - pf).abs().max())
        assert err_f <= 1e-4, f"{mode} f32 warp differs from plain by {err_f} > 1e-4"
        ku = warp_kernel.warp(img_u8, smap, fill=0.0, filter_mode=mode)
        pu = remap_ops.remap_plain(img_u8, smap, fill=0.0, filter_mode=mode)
        max_lsb, frac = _u8_diff(ku, pu)
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"{mode} u8 warp: max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
        kernel = lambda: warp_kernel.warp(img_u8, smap, fill=0.0, filter_mode=mode)  # noqa: E731
        ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
        plain_ms = _median_ms(lambda: remap_ops.remap_plain(img_u8, smap, fill=0.0, filter_mode=mode))
        print(f"K1 warp {mode}: f32 max|err| {err_f:.3e}; u8 max {max_lsb} LSB on "
              f"{frac:.2e} of pixels; kernel {ms:.4f} ms ({gap_ms:.4f} without the device "
              f"spin), plain {plain_ms:.4f} ms (u8 3x{H}x{W}, median of {RUNS})", flush=True)
        report[mode] = {"max_abs_err": max_lsb, "ms": ms, "plain_ms": plain_ms, "f32_err": err_f}
    n_easu, n_src = _easu_work(smap, H, W)
    report["easu"]["bound_ms"], report["easu"]["bound_by"] = _bound(
        img_u8.numel() * 2 + smap.numel() * 4, _easu_ops(n_easu, n_src, 3))
    print(f"K1 warp easu: {used} blocks stage their source box, {over} gather from device "
          f"memory; bound {report['easu']['bound_ms']:.4f} ms ({report['easu']['bound_by']}, "
          f"{n_easu} EASU outputs, {n_src} corner pixels)", flush=True)

    # The bilinear mode's yardstick: one grid_sample call on the f32 frame.
    # Outside the frame the kernel fills where grid_sample clamps, so the
    # two are compared inside it.
    grid = torch.stack([smap[1] * (2.0 / (W - 1)) - 1.0, smap[0] * (2.0 / (H - 1)) - 1.0],
                       dim=-1)[None].contiguous()
    gs = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        img_f[None], grid, mode="bilinear", padding_mode="border", align_corners=True)
    inside = (smap[0] >= 0) & (smap[0] <= H - 1) & (smap[1] >= 0) & (smap[1] <= W - 1)
    pf = remap_ops.remap_plain(img_f, smap, fill=0.0, filter_mode="bilinear")
    gs_err = float(((gs()[0] - pf).abs() * inside).max())
    bil_f32_ms = _median_ms(lambda: warp_kernel.warp(img_f, smap, fill=0.0, filter_mode="bilinear"))
    gs_ms = _median_ms(gs)
    print(f"K1 warp bilinear f32 3x{H}x{W}: kernel {bil_f32_ms:.4f} ms, F.grid_sample "
          f"{gs_ms:.4f} ms (max |grid_sample - plain| inside the frame {gs_err:.3e})", flush=True)
    report["bilinear"].update(f32_ms=bil_f32_ms, library_ms=gs_ms, library_err=gs_err)

    for name, (scale, angle) in OVERFLOW_MAPS.items():
        omap = _affine_map((H, W), scale, angle, dev)
        used, over = _paths(lambda c: warp_kernel.warp(img_u8, omap, block_paths=c), dev)
        assert over >= used // 2, f"{name}: only {over} of {used} blocks overflow the box"
        err_f = float((warp_kernel.warp(img_f, omap) - remap_ops.remap_plain(
            img_f, omap, filter_mode="easu")).abs().max())
        assert err_f <= 1e-4, f"{name}: f32 warp differs from plain by {err_f} > 1e-4"
        max_lsb, frac = _u8_diff(warp_kernel.warp(img_u8, omap),
                                 remap_ops.remap_plain(img_u8, omap, filter_mode="easu"))
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"{name}: u8 warp max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
        ms = _median_ms(lambda: warp_kernel.warp(img_u8, omap))
        print(f"K1 warp easu, {name}: {over} of {used} blocks gather from device memory; f32 "
              f"max|err| {err_f:.3e}; u8 max {max_lsb} LSB on {frac:.2e} of pixels; kernel "
              f"{ms:.4f} ms (u8)", flush=True)
    return report


def check_warp_batched(dev, rng) -> dict:
    """K2 at S = STREAMS on 3x1080x1920 u8 and f32 frames, each stream by its
    own stabilization-scale similarity (some leaving the frame), EASU and
    bilinear: against the plain batched version with K1's bounds, and
    bit-equal to STREAMS solo K1 launches."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    base = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)])
    img_f = torch.stack([torch.roll(base, (37 * s, 61 * s), dims=(1, 2)) for s in range(STREAMS)])
    img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
    sims = [(1.0 + 0.004 * s, math.radians(0.25 * (s - 3)), 6.0 * s - 20.0, 9.0 - 3.0 * s)
            for s in range(STREAMS)]
    smaps = torch.stack([_similarity(*p, dev).sample_map((H, W)) for p in sims]).contiguous()
    out = (smaps[:, 0] < 0) | (smaps[:, 0] > H - 1) | (smaps[:, 1] < 0) | (smaps[:, 1] > W - 1)
    n_out = [int(v) for v in out.sum(dim=(1, 2))]
    assert sum(v > 1000 for v in n_out) >= STREAMS // 2, f"maps leave the frame by {n_out} px"
    report = {}
    for mode in ("easu", "bilinear"):
        kw = dict(fill=0.0, filter_mode=mode)
        kf = warp_kernel.warp_batched(img_f, smaps, **kw)
        pf = remap_ops.remap_batched_plain(img_f, smaps, **kw)
        err_f = float((kf - pf).abs().max())
        del pf
        assert err_f <= 1e-4, f"{mode} f32 batched warp differs from plain by {err_f} > 1e-4"
        solo_f = torch.stack([warp_kernel.warp(img_f[s], smaps[s], **kw) for s in range(STREAMS)])
        assert torch.equal(kf, solo_f), f"{mode} f32 batched warp is not bit-equal to solo K1"
        del kf, solo_f
        ku = warp_kernel.warp_batched(img_u8, smaps, **kw)
        pu = remap_ops.remap_batched_plain(img_u8, smaps, **kw)
        max_lsb, frac = _u8_diff(ku, pu)
        del pu
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"{mode} u8 batched warp: max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
        solo_u = torch.stack([warp_kernel.warp(img_u8[s], smaps[s], **kw) for s in range(STREAMS)])
        assert torch.equal(ku, solo_u), f"{mode} u8 batched warp is not bit-equal to solo K1"
        del ku, solo_u
        kernel = lambda: warp_kernel.warp_batched(img_u8, smaps, **kw)  # noqa: E731
        ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
        plain_ms = _median_ms(lambda: remap_ops.remap_batched_plain(img_u8, smaps, **kw))
        solo_ms = _median_ms(lambda: [warp_kernel.warp(img_u8[s], smaps[s], **kw)
                                      for s in range(STREAMS)])
        print(f"K2 warp_batched {mode}: {STREAMS} streams, f32 max|err| {err_f:.3e}; u8 max "
              f"{max_lsb} LSB on {frac:.2e} of pixels; bit-equal to {STREAMS} solo K1; kernel "
              f"{ms:.4f} ms ({gap_ms:.4f} without the device spin), plain {plain_ms:.4f} ms, {STREAMS} x solo K1 {solo_ms:.4f} ms "
              f"(u8 {STREAMS}x3x{H}x{W}, median of {RUNS})", flush=True)
        report[mode] = {"max_abs_err": max_lsb, "ms": ms, "plain_ms": plain_ms,
                        "solo_ms": solo_ms, "f32_err": err_f}
    n_easu, n_src = _easu_work(smaps, H, W)
    report["easu"]["bound_ms"], report["easu"]["bound_by"] = _bound(
        img_u8.numel() * 2 + smaps.numel() * 4, _easu_ops(n_easu, n_src, 3))
    print(f"K2 warp_batched easu: bound {report['easu']['bound_ms']:.4f} ms "
          f"({report['easu']['bound_by']}, {n_easu} EASU outputs, {n_src} corner pixels)",
          flush=True)

    # Streams under the overflowing maps (each a little apart), EASU.
    kinds = list(OVERFLOW_MAPS.values())
    omaps = torch.stack([_affine_map((H, W), kinds[s % 2][0] * (1.0 + 0.01 * s),
                                     kinds[s % 2][1] + 0.01 * s, dev) for s in range(STREAMS)])
    paths = [_paths(lambda c, m=m: warp_kernel.warp(img_u8[0], m, block_paths=c), dev) for m in omaps]
    assert all(over >= used // 2 for used, over in paths), f"blocks (used, over): {paths}"
    kf = warp_kernel.warp_batched(img_f, omaps)
    err_f = float((kf - remap_ops.remap_batched_plain(img_f, omaps, filter_mode="easu")).abs().max())
    assert err_f <= 1e-4, f"overflowing batched f32 warp differs from plain by {err_f} > 1e-4"
    assert torch.equal(kf, torch.stack([warp_kernel.warp(img_f[s], omaps[s]) for s in range(STREAMS)]))
    del kf
    ku = warp_kernel.warp_batched(img_u8, omaps)
    max_lsb, frac = _u8_diff(ku, remap_ops.remap_batched_plain(img_u8, omaps, filter_mode="easu"))
    assert max_lsb <= 1 and frac <= 1e-3, (
        f"overflowing batched u8 warp: max {max_lsb} LSB on {frac:.2e} of pixels")
    assert torch.equal(ku, torch.stack([warp_kernel.warp(img_u8[s], omaps[s]) for s in range(STREAMS)]))
    del ku
    print(f"K2 warp_batched easu under zoom-out / rotation maps: {sum(o for _, o in paths)} of "
          f"{sum(u for u, _ in paths)} blocks gather from device memory; f32 max|err| "
          f"{err_f:.3e}; u8 max {max_lsb} LSB on {frac:.2e} of pixels; bit-equal to {STREAMS} "
          f"solo K1", flush=True)
    return report


LK_SIZE = (272, 480)  # the flagship's detection size: K3's level 0


def _lk_frames(dev, rng, motion):
    """Two LK_SIZE frames over a fresh texture, the second moved by the
    similarity `motion` (angle in degrees, dx, dy) against the first."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops

    ang, dx, dy = motion
    tex = torch.from_numpy(_texture(400, 640, rng)).to(dev)
    f0 = remap_ops.remap_plain(
        tex, _similarity(1.0, 0.0, 60.0, 50.0, dev).sample_map(LK_SIZE, inverse=False), fill=0.5)
    f1 = remap_ops.remap_plain(tex, _similarity(1.0, math.radians(ang), 60.0 + dx, 50.0 + dy,
                                                dev).sample_map(LK_SIZE, inverse=False), fill=0.5)
    return f0, f1


def _lk_features(f0, f1):
    """(prev levels, next levels, points, valid): the flagship's 3-level
    pyramids of the pair and its 510 grid features on the first frame."""
    from livevisionkit_tpu_torch.config import FeatureDetectorSettings, OpticalFlowSettings
    from livevisionkit_tpu_torch.vision import features, optical_flow

    det = FeatureDetectorSettings()
    levels = OpticalFlowSettings().pyramid_levels
    feats, _ = features.detect(f0, features.initial_thresholds(det, f0.device), det)
    assert feats.points.shape == (510, 2)
    return (optical_flow.Pyramid.build(f0, levels).levels,
            optical_flow.Pyramid.build(f1, levels).levels,
            feats.points.contiguous(), feats.valid)


def lk_inputs(dev, rng):
    """K3's solo inputs: a shifted and rotated texture at 272x480."""
    return _lk_features(*_lk_frames(dev, rng, (0.6, 2.5, -1.2)))


def lk_batched_inputs(dev, rng):
    """K3's STREAMS-stream inputs: each stream its own texture and motion,
    (S, H_l, W_l) levels, (S, 510, 2) points and (S, 510) valid flags."""
    per = [_lk_features(*_lk_frames(dev, rng, (0.2 * s - 0.6, 0.7 * s - 2.0, 1.0 - 0.4 * s)))
           for s in range(STREAMS)]
    return ([torch.stack(lv) for lv in zip(*(p[0] for p in per))],
            [torch.stack(lv) for lv in zip(*(p[1] for p in per))],
            torch.stack([p[2] for p in per]), torch.stack([p[3] for p in per]))


def _lk_bound(levels, n_feat: int, n_levels: int, n_streams: int = 1) -> tuple[float, str]:
    """K3's bound: the pyramids' bytes read once, the points, initial flow
    and outputs (25 B a feature), and `_lk_ops`, per stream."""
    from livevisionkit_tpu_torch.config import OpticalFlowSettings

    s = OpticalFlowSettings()
    return _bound(4 * sum(lv.numel() for lv in levels) + 25 * n_feat * n_streams,
                  n_streams * _lk_ops(n_feat, n_levels, s.window_size, s.iterations))


def _lk_compare(kflow, kgood, pflow, pgood, valid, what: str) -> tuple[float, float, int]:
    """Max flow error over the features both mark tracked and the masks'
    agreement over the valid ones, held to 1e-3 px and 99%."""
    both = kgood & pgood & valid
    assert int(both.sum()) >= 100, f"{what}: too few features tracked by both ({int(both.sum())})"
    err = float((kflow - pflow)[both].abs().max())
    agree = float((kgood == pgood)[valid].float().mean())
    assert err <= 1e-3, f"{what}: flow differs from plain by {err} px > 1e-3"
    assert agree >= 0.99, f"{what}: tracked masks agree on {agree:.4f} < 0.99 of features"
    return err, agree, int(both.sum())


def _restaged(launch, dev) -> int:
    """Features whose search window left its staged box in `launch(count)`."""
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(count)
    return int(count.item())


def empty_kernel_ms() -> float:
    """An empty one-warp kernel of the library under `_median_ms`: the
    floor under which no launch can be timed."""
    from livevisionkit_tpu_torch.ops.cuda_kernels import build

    lib = build.library()
    return _median_ms(lambda: build.check(lib.lvk_noop(torch.cuda.current_stream().cuda_stream),
                                          "noop"))


def check_lk(dev, rng) -> dict:
    """K3 against its plain version on a 3-level 272x480 pyramid with the
    flagship's 510 grid features, on a shifted and rotated texture; then
    K4, its n_levels = 1 call, on level 0 of the same pair against the
    plain version on one-level pyramids.  With an empty kernel's time, the
    floor K3 is read against."""
    from livevisionkit_tpu_torch.config import OpticalFlowSettings
    from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
    from livevisionkit_tpu_torch.vision import optical_flow

    flow_s = OpticalFlowSettings()
    prev, nxt, pts, valid = lk_inputs(dev, rng)
    n_feat = pts.shape[0]
    zero = torch.zeros_like(pts)
    tail = (flow_s.window_size, flow_s.iterations, flow_s.min_eigen_threshold)
    floor_ms = empty_kernel_ms()
    print(f"K3 floor: an empty kernel of the library takes {floor_ms:.4f} ms under the same "
          f"timer (median of {RUNS})", flush=True)
    report = {}
    for name, lv in (("lk_track", len(prev)), ("lk_level", 1)):
        p0, p1 = optical_flow.Pyramid(prev[:lv]), optical_flow.Pyramid(nxt[:lv])
        args = (p0.levels, p1.levels, pts, zero, *tail)
        kflow, kgood = lk_kernel.lk_track(*args)
        pflow, pgood = optical_flow.track_plain(p0, p1, pts, flow_s)
        what = "K3 lk_track" if lv > 1 else "K4 lk_level (K3 with n_levels = 1)"
        err, agree, n_both = _lk_compare(kflow, kgood, pflow, pgood, valid, what)
        restaged = _restaged(lambda c: lk_kernel.lk_track(*args, restaged=c), dev)
        ms, gap_ms = _median_ms(lambda: lk_kernel.lk_track(*args)), _median_ms(
            lambda: lk_kernel.lk_track(*args), spin=False)
        plain_ms = _median_ms(lambda: optical_flow.track_plain(p0, p1, pts, flow_s))
        bound_ms, bound_by = _lk_bound((*p0.levels, *p1.levels), n_feat, lv)
        print(f"{what}: max|flow err| {err:.3e} px over {n_both} features, masks agree on "
              f"{agree:.4f}; {restaged} of {n_feat} features restaged their search box; kernel "
              f"{ms:.4f} ms ({gap_ms:.4f} without the device spin), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) ({lv} level(s) of {LK_SIZE[0]}x{LK_SIZE[1]}, "
              f"{n_feat} features, median of {RUNS})", flush=True)
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "restaged": restaged}
    report["floor_ms"] = floor_ms
    return report


def check_lk_batched(dev, rng) -> dict:
    """K3 with the stream axis: STREAMS pyramid pairs (3 levels of 272x480,
    each its own texture and motion, 510 grid features each) in one launch,
    against the plain version under vmap; its bound is STREAMS times the
    solo one."""
    from livevisionkit_tpu_torch.config import OpticalFlowSettings
    from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
    from livevisionkit_tpu_torch.vision import optical_flow

    flow_s = OpticalFlowSettings()
    prev, nxt, pts, valid = lk_batched_inputs(dev, rng)
    zero = torch.zeros_like(pts)
    args = (prev, nxt, pts, zero, flow_s.window_size, flow_s.iterations, flow_s.min_eigen_threshold)
    kflow, kgood = lk_kernel.lk_track(*args)
    pflow, pgood = optical_flow.track_batched_plain(prev, nxt, pts, flow_s)
    errs, agrees = zip(*(_lk_compare(kflow[s], kgood[s], pflow[s], pgood[s], valid[s],
                                     f"batched K3, stream {s}")[:2] for s in range(STREAMS)))
    err, agree = max(errs), min(agrees)
    restaged = _restaged(lambda c: lk_kernel.lk_track(*args, restaged=c), dev)
    ms, gap_ms = _median_ms(lambda: lk_kernel.lk_track(*args)), _median_ms(
        lambda: lk_kernel.lk_track(*args), spin=False)
    plain_ms = _median_ms(lambda: optical_flow.track_batched_plain(prev, nxt, pts, flow_s))
    bound_ms, bound_by = _lk_bound((*prev, *nxt), pts.shape[1], len(prev), STREAMS)
    print(f"K3 lk_track, {STREAMS} streams in one launch: max|flow err| {err:.3e} px, masks "
          f"agree on >= {agree:.4f}; {restaged} of {pts.shape[0] * pts.shape[1]} features "
          f"restaged their search box; kernel {ms:.4f} ms ({gap_ms:.4f} without the device "
          f"spin), plain (vmap) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(3 levels of {STREAMS}x272x480, {STREAMS}x510 features, median of {RUNS})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "restaged": restaged}


def _easu_scale_bound(in_size, size, dev, n_streams: int = 1) -> tuple[float, str]:
    """K5's bound for n_streams 3-channel f32 frames of in_size scaled to
    size: each source and output once, and the EASU operations of every
    output but the border's nearest taps, per stream."""
    from livevisionkit_tpu_torch.ops import easu as easu_ops

    (h, w), plan = in_size, easu_ops.scale_plan(in_size, size)
    if plan.rational:
        y0, _ = easu_ops._axis_rational(size[0], plan.py, plan.qy, dev)
        x0, _ = easu_ops._axis_rational(size[1], plan.px, plan.qx, dev)
    else:
        y0, _ = easu_ops._axis_fallback(h, size[0], dev)
        x0, _ = easu_ops._axis_fallback(w, size[1], dev)
    rows, cols = y0[(y0 >= 1) & (y0 < h - 4)], x0[(x0 >= 1) & (x0 < w - 4)]
    n_src = len(torch.cat([rows, rows + 1]).unique()) * len(torch.cat([cols, cols + 1]).unique())
    return _bound(n_streams * 4 * 3 * (h * w + size[0] * size[1]),
                  n_streams * _easu_ops(len(rows) * len(cols), n_src, 3))


def check_easu_scale(dev, rng) -> dict:
    """K5 against its plain version on SCALE_CASES, f32 YUV: the chain's
    1080p -> 4K (2x, the TPU kernel's case), the reference scaler's default
    720p -> 1080p (3/2) and one fallback ratio (1080p -> 1600x2844)."""
    from livevisionkit_tpu_torch.ops import easu as easu_ops
    from livevisionkit_tpu_torch.types import PixelFormat

    report = {}
    for (h, w), size in SCALE_CASES:
        luma = torch.from_numpy(_texture(h, w, rng)).to(dev)
        img = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
        plan = easu_ops.scale_plan((h, w), size)
        got = easu_ops.easu_scale(img, size, PixelFormat.YUV)
        want = easu_ops.easu_scale_plain(img, size, PixelFormat.YUV)
        assert got.shape == want.shape == (3, *size)
        err = float((got - want).abs().max())
        del got, want
        assert err <= 1e-5, f"easu_scale {h}x{w} -> {size} differs from plain by {err} > 1e-5"
        kernel = lambda: easu_ops.easu_scale(img, size, PixelFormat.YUV)  # noqa: E731
        ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
        plain_ms = _median_ms(lambda: easu_ops.easu_scale_plain(img, size, PixelFormat.YUV))
        bound_ms, bound_by = _easu_scale_bound((h, w), size, dev)
        form = "rational" if plan.rational else "fallback"
        print(f"K5 easu_scale 3x{h}x{w} -> {size[0]}x{size[1]} ({form} {plan.py}/{plan.qy}, "
              f"{plan.px}/{plan.qx}): max|err| {err:.3e}; kernel {ms:.4f} ms ({gap_ms:.4f} without "
              f"the device spin), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) (f32, median of {RUNS})",
              flush=True)
        report[size] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
    return report


def rcas_input(dev, rng) -> torch.Tensor:
    """The chain's 3x2160x3840 f32 frame: a 4K EASU upscale of a texture."""
    from livevisionkit_tpu_torch.ops import easu as easu_ops

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    small = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
    return easu_ops.easu_scale_plain(small, OUT).contiguous()


def check_rcas(dev, rng) -> dict:
    """K6 against its plain version on the chain's 3x2160x3840 f32 frame
    at sharpness 0.8; beside it a `torch.clone` of the frame, which moves
    the same bytes: the bandwidth the card reaches."""
    from livevisionkit_tpu_torch.ops import rcas as rcas_ops

    img = rcas_input(dev, rng)
    got = rcas_ops.rcas(img, 0.8)
    want = rcas_ops.rcas_plain(img, 0.8)
    err = float((got - want).abs().max())
    moved = float((got - img).abs().max())
    del got, want
    assert err <= 1e-6, f"rcas differs from plain by {err} > 1e-6"
    assert moved > 1e-3, f"rcas changed no pixel by more than {moved}"
    ms, gap_ms = _median_ms(lambda: rcas_ops.rcas(img, 0.8)), _median_ms(
        lambda: rcas_ops.rcas(img, 0.8), spin=False)
    plain_ms = _median_ms(lambda: rcas_ops.rcas_plain(img, 0.8))
    clone_ms = _median_ms(img.clone)
    bound_ms, bound_by = _bound(4 * 2 * img.numel(), _rcas_ops(3, *OUT))
    print(f"K6 rcas 3x{OUT[0]}x{OUT[1]}: max|err| {err:.3e}; kernel {ms:.4f} ms ({gap_ms:.4f} "
          f"without the device spin), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) (f32, sharpness 0.8, median of {RUNS}); "
          f"floor: torch.clone of the frame {clone_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "clone_ms": clone_ms}


def _stream_stack(frame: torch.Tensor) -> torch.Tensor:
    """STREAMS distinct frames from one: each rolled by its own shift."""
    return torch.stack([torch.roll(frame, (37 * s, 61 * s), dims=(-2, -1)) for s in range(STREAMS)])


def check_easu_scale_x8(dev, rng) -> dict:
    """K5's stream axis at the chain tick's shape: STREAMS 3x1080x1920 f32
    frames -> 3x2160x3840 in one launch, bit-equal to STREAMS solo launches,
    also for one frame shared at stream stride 0, and against the plain
    version under vmap; its bound is STREAMS times the solo one."""
    from livevisionkit_tpu_torch.ops import easu as easu_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import easu_scale as k5

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    base = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)])
    imgs = _stream_stack(base).contiguous()
    plan = easu_ops.scale_plan((H, W), OUT)
    got = k5.easu_scale_batched(imgs, OUT, plan)
    solo = lambda: [k5.easu_scale(imgs[s], OUT, plan) for s in range(STREAMS)]  # noqa: E731
    assert all(torch.equal(got[s], o) for s, o in enumerate(solo())), "K5 x8 is not bit-equal to solo K5"
    shared = k5.easu_scale_batched(imgs[-1][None].expand(STREAMS, -1, -1, -1), OUT, plan)
    one = k5.easu_scale(imgs[-1], OUT, plan)
    assert all(torch.equal(shared[s], one) for s in range(STREAMS)), "K5 x8 at stride 0 differs"
    del shared, one
    err = max(float((got[s] - easu_ops.easu_scale_plain(imgs[s], OUT)).abs().max())
              for s in range(STREAMS))
    del got
    assert err <= 1e-5, f"K5 x8 differs from plain by {err} > 1e-5"
    kernel = lambda: k5.easu_scale_batched(imgs, OUT, plan)  # noqa: E731
    ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
    solo_ms = _median_ms(solo)
    plain_ms = _median_ms(lambda: easu_ops.easu_scale_batched_plain(imgs, OUT), runs=3)
    bound_ms, bound_by = _easu_scale_bound((H, W), OUT, dev, STREAMS)
    print(f"K5 easu_scale x{STREAMS}: {STREAMS}x3x{H}x{W} -> {OUT[0]}x{OUT[1]} in one launch, "
          f"bit-equal to {STREAMS} solo K5 (also at stream stride 0); max|err| {err:.3e}; kernel "
          f"{ms:.4f} ms ({gap_ms:.4f} without the device spin), {STREAMS} x solo K5 {solo_ms:.4f} "
          f"ms, plain (vmap) {plain_ms:.4f} ms (median of 3), bound {bound_ms:.4f} ms ({bound_by}, "
          f"{STREAMS} x solo) (f32, median of {RUNS})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "solo_ms": solo_ms}


def check_rcas_x8(dev, rng) -> dict:
    """K6's stream axis at the chain tick's shape: STREAMS 3x2160x3840 f32
    frames in one launch, bit-equal to STREAMS solo launches and to the
    plain version, also for one frame shared at stream stride 0; beside it
    a `torch.clone` of the stack (the same bytes)."""
    from livevisionkit_tpu_torch.ops import rcas as rcas_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import rcas as k6

    imgs = _stream_stack(rcas_input(dev, rng)).contiguous()
    got = k6.rcas_batched(imgs, 0.8)
    solo = lambda: [k6.rcas(imgs[s], 0.8) for s in range(STREAMS)]  # noqa: E731
    assert all(torch.equal(got[s], o) for s, o in enumerate(solo())), "K6 x8 is not bit-equal to solo K6"
    shared = k6.rcas_batched(imgs[-1][None].expand(STREAMS, -1, -1, -1), 0.8)
    one = k6.rcas(imgs[-1], 0.8)
    assert all(torch.equal(shared[s], one) for s in range(STREAMS)), "K6 x8 at stride 0 differs"
    del shared, one
    err = max(float((got[s] - rcas_ops.rcas_plain(imgs[s], 0.8)).abs().max()) for s in range(STREAMS))
    del got
    assert err <= 1e-6, f"K6 x8 differs from plain by {err} > 1e-6"
    kernel = lambda: k6.rcas_batched(imgs, 0.8)  # noqa: E731
    ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
    solo_ms = _median_ms(solo)
    plain_ms = _median_ms(lambda: rcas_ops.rcas_batched_plain(imgs, 0.8))
    clone_ms = _median_ms(imgs.clone)
    bound_ms, bound_by = _bound(4 * 2 * imgs.numel(), STREAMS * _rcas_ops(3, *OUT))
    print(f"K6 rcas x{STREAMS}: {STREAMS}x3x{OUT[0]}x{OUT[1]} in one launch, bit-equal to "
          f"{STREAMS} solo K6 (also at stream stride 0); max|err| {err:.3e}; kernel {ms:.4f} ms "
          f"({gap_ms:.4f} without the device spin), {STREAMS} x solo K6 {solo_ms:.4f} ms, plain "
          f"(vmap) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {STREAMS} x solo) (f32, "
          f"median of {RUNS}); floor: torch.clone of the stack {clone_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "solo_ms": solo_ms, "clone_ms": clone_ms}


def _timed(n: int) -> int:
    """Steps timed at the end of an n-step drive: the last N_TIMED of a
    full N_FRAMES drive, the last half of a shorter one."""
    return N_TIMED if n >= N_FRAMES else n // 2


def _drive(filt, state, frames, per_frame, n=None):
    """Step `filt` over `frames` (n of them, by default len(frames)) with
    synchronizing calls made errors; return the state, device ms/frame
    (CUDA events) and host ms/frame over the last `_timed(n)` frames.
    `per_frame(t, state, out)` keeps what is checked."""
    n = len(frames) if n is None else n
    timed = _timed(n)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall0 = 0.0
    # The step must never wait for the device (that is what lets it be
    # captured in a CUDA graph): any synchronizing call in it raises here.
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t, fr in enumerate(frames):
            if t == n - timed:
                start.record()
                wall0 = time.perf_counter()
            state, out = filt.step(state, fr)
            per_frame(t, state, out)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - wall0) * 1e3 / timed
    return state, start.elapsed_time(end) / timed, wall_ms


def run_solo(name, filt, dev, rng, profile_dir: str | None) -> dict:
    """60 1080p frames of a fresh shaky clip through the stabilizer `filt`
    on the card: one warp (K1) and one LK launch (K3) a step, valid flags
    from frame `filt.delay`, finite outputs, tracker ok on >= 90% of frames
    and output jitter below input jitter."""
    import livevisionkit_tpu_torch as lvk

    poses, frames = _shaky_clip(dev, rng)
    n = len(frames)
    delay = filt.delay  # output lag in frames (the predictive window)
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    # One step on a throwaway state fills the per-shape caches (the resize
    # weights), so the measured run below meets no first-use work.
    filt.step(filt.init(spec, device=dev), frames[0])
    state = filt.init(spec, device=dev)
    torch.cuda.synchronize()

    # Per frame, only 0-d flags and the correction are kept: holding every
    # 1080p output would make the allocator take fresh device memory each
    # step, which a streaming consumer never pays.
    valids, finite, corrections, stabilities = [], [], [], []

    def keep(t, st, out):
        assert out.pixels.shape == (3, H, W)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).all())
        corrections.append(st.correction.offsets)
        stabilities.append(st.stability)

    _reset_launches()
    state, gpu_ms, wall_ms = _drive(filt, state, frames, keep)
    launches = _launches()

    want = _want(warp=n, lk_track=n)
    assert launches == want, f"{name}: kernel launches {launches}, want {want}"
    valid = [bool(v) for v in valids]
    assert valid == [t >= delay for t in range(n)], f"{name}: valid flags {valid}"
    bad = [t for t, f in enumerate(finite) if not bool(f)]
    assert not bad, f"{name}: non-finite output pixels in frames {bad}"
    ok = [float(s) > 0.0 for s in stabilities[1:]]
    ok_frac = sum(ok) / len(ok)
    assert ok_frac >= 0.9, f"{name}: tracker ok on {ok_frac:.3f} < 0.9 of frames"
    j_in, j_out = _jitter(poses, torch.stack(corrections).cpu(), delay)
    assert j_out < j_in, f"{name}: output jitter {j_out:.3f} px not below input {j_in:.3f} px"
    field = "x".join(map(str, corrections[0].shape[-2:]))
    print(f"{name}: {n} 1080p frames, {field} motion field, valid from frame {delay}, tracker ok "
          f"on {ok_frac:.3f} of frames, jitter {j_in:.3f} -> {j_out:.3f} px, launches {launches}",
          flush=True)
    print(f"{name}: {gpu_ms:.4f} ms/frame on the device (CUDA events over the last {N_TIMED} "
          f"frames), {wall_ms:.4f} ms/frame host wall clock", flush=True)
    if profile_dir:
        _profile(filt.step, state, frames, os.path.join(profile_dir, name))
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
            "jitter_in": j_in, "jitter_out": j_out, "state": state, "frames": frames}


def run_slice(dev, rng, profile_dir: str | None) -> dict:
    """The flagship stabilizer (homography mode, a 2x2 field)."""
    import livevisionkit_tpu_torch as lvk

    rep = run_solo("slice", lvk.flagship_filter(), dev, rng, profile_dir)
    del rep["state"], rep["frames"]
    return rep


def run_mesh(dev, rng, profile_dir: str | None) -> dict:
    """The stabilizer in mesh mode, `stabilization_preset(model="field")`
    (the JAX package's `1080p_mesh_stabilization`, tools/bench_matrix.py:
    95-99): a 16x16 mesh solved by CG over 272x480 detection, 17x30 grid,
    256 hypotheses, a 10-frame window and the EASU warp through K1 on the
    mesh's dense (2, 1080, 1920) sample map.  Then K1 on the last step's
    dense map against its plain version, with its device-memory tiles."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
    from livevisionkit_tpu_torch.presets import stabilization_preset

    filt = lvk.StabilizationFilter(settings=stabilization_preset(model="field"))
    assert tuple(filt.settings.tracker.motion_resolution) == (16, 16)
    rep = run_solo("mesh", filt, dev, rng, profile_dir)
    state, frames = rep.pop("state"), rep.pop("frames")
    smap = state.correction.sample_map((H, W)).contiguous()
    img_f = frames[-1].pixels.contiguous()
    img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
    used, over = _paths(lambda c: warp_kernel.warp(img_u8, smap, block_paths=c), dev)
    err_f = float((warp_kernel.warp(img_f, smap) - remap_ops.remap_plain(
        img_f, smap, filter_mode="easu")).abs().max())
    assert err_f <= 1e-4, f"mesh map: f32 warp differs from plain by {err_f} > 1e-4"
    max_lsb, frac = _u8_diff(warp_kernel.warp(img_u8, smap),
                             remap_ops.remap_plain(img_u8, smap, filter_mode="easu"))
    assert max_lsb <= 1 and frac <= 1e-3, (
        f"mesh map: u8 warp max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
    ms = _median_ms(lambda: warp_kernel.warp(img_u8, smap))
    span = float((smap - remap_ops.identity_map((H, W), device=dev)).abs().max())
    print(f"K1 warp easu on the mesh's dense map (|map - identity| <= {span:.2f} px): {over} of "
          f"{used} blocks gather from device memory; f32 max|err| {err_f:.3e}; u8 max {max_lsb} "
          f"LSB on {frac:.2e} of pixels; kernel {ms:.4f} ms (u8)", flush=True)
    rep.update(k1_over=over, k1_used=used, k1_ms=ms, k1_err=err_f)
    return rep


def _point_out(offsets: torch.Tensor, x: np.ndarray) -> np.ndarray:
    """Where a correction field (normalized (2, hm, wm) offsets, on the
    CPU) puts the (x, y) point x of the delayed frame: a 2x2 field by its
    exact homography, a mesh to first order, x - o(x) * (size - 1) with o
    read bilinearly in the grid (as tools/oracle_pipeline.py reads it)."""
    from livevisionkit_tpu_torch.models.warp_field import WarpField

    if tuple(offsets.shape[-2:]) == (2, 2):
        pt = torch.from_numpy(np.asarray(x, np.float32)[None])
        return WarpField(offsets=offsets).to_homography((H, W)).transform(pt)[0].numpy()
    c = offsets.numpy()
    gh, gw = c.shape[1:]
    fy = float(np.clip(x[1] / (H - 1), 0.0, 1.0)) * (gh - 1)
    fx = float(np.clip(x[0] / (W - 1), 0.0, 1.0)) * (gw - 1)
    y0, x0 = min(int(fy), gh - 2), min(int(fx), gw - 2)
    wy, wx = fy - y0, fx - x0
    v = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x0 + 1] * (1 - wy) * wx
         + c[:, y0 + 1, x0] * wy * (1 - wx) + c[:, y0 + 1, x0 + 1] * wy * wx)
    return np.asarray(x) - np.array([v[1] * (W - 1), v[0] * (H - 1)])


def _jitter(poses, corrections, delay: int) -> tuple[float, float]:
    """Jitter of a scene point's path in the input and in the output: input
    x_t = P_t^-1(s); the output at step t shows frame t - delay, corrected
    (`_point_out`).  `poses` are one stream's and `corrections` its (2, hm,
    wm) correction offsets per step, on the CPU."""
    from livevisionkit_tpu_torch.models.homography import Homography
    from livevisionkit_tpu_torch.utils import metrics

    s_pt = torch.tensor([[W / 2 + 160.0, H / 2 + 160.0]])
    x_in, y_out = [], []
    for t in range(delay, len(corrections)):
        x = Homography(m=poses[t - delay].m.cpu()).inverse().transform(s_pt)[0].numpy()
        x_in.append(x)
        y_out.append(_point_out(corrections[t], x))
    return metrics.jitter(np.array(x_in)), metrics.jitter(np.array(y_out))


def run_streams(name, filt, dev, poses, clips, n, want, profile_dir: str | None) -> dict:
    """STREAMS 1080p streams, each its own shaky clip (u8 on the card),
    through `MultiStreamFilter(filt, STREAMS).step` for n ticks with
    synchronizing calls made errors: `want(n)` launches of each kernel
    (one batched launch each a tick), no solo launch, no per-stream
    fallback.  Per stream: valid flags from tick `filt.delay`, finite
    outputs of the filter's output size, tracker ok on >= 90% of ticks and
    output jitter below input jitter.  `filt` is a stabilizer, or a chain
    whose first stage is one."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter

    multi = MultiStreamFilter(filt, STREAMS)
    delay = filt.delay
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    out_spec = filt.output_spec(spec)
    live = torch.ones(STREAMS, dtype=torch.bool, device=dev)
    stab = (lambda st: st[0]) if isinstance(filt, lvk.CompositeFilter) else (lambda st: st)

    def frame(t):
        return lvk.Frame(pixels=clips[:, t].to(torch.float32) * (1.0 / 255.0),
                         timestamp=torch.full((STREAMS,), t / 30.0, device=dev), valid=live,
                         format=lvk.PixelFormat.YUV)

    multi.step(multi.init(spec, device=dev), frame(0))  # fills the per-shape caches
    state = multi.init(spec, device=dev)
    torch.cuda.synchronize()

    valids, finite, corrections, stabilities, lo, hi = [], [], [], [], [], []

    def keep(t, st, out):
        assert out.pixels.shape == (STREAMS, 3, out_spec.height, out_spec.width)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).flatten(1).all(dim=1))
        lo.append(out.pixels.amin())
        hi.append(out.pixels.amax())
        corrections.append(stab(st).correction.offsets)
        stabilities.append(stab(st).stability)

    _reset_launches()
    state, gpu_ms, wall_ms = _drive(multi, state, (frame(t) for t in range(n)), keep, n=n)
    launches = _launches()

    assert launches == want, f"{name}: kernel launches {launches}, want {want}"
    valid = torch.stack(valids).cpu().numpy()  # (ticks, streams)
    finite = torch.stack(finite).cpu().numpy()
    ok = (torch.stack(stabilities)[1:] > 0.0).float().mean(dim=0).cpu().numpy()
    corr = torch.stack(corrections).cpu()
    lo_all, hi_all = float(torch.stack(lo).min()), float(torch.stack(hi).max())
    # The warp fills with 0, EASU de-rings into its taps and RCAS keeps
    # [0, 1] input inside [0, 1].
    assert -1e-5 <= lo_all and hi_all <= 1.0 + 1e-5, f"{name}: outputs span [{lo_all}, {hi_all}]"
    jitter = []
    for s in range(STREAMS):
        assert list(valid[:, s]) == [t >= delay for t in range(n)], f"{name}: stream {s} valid {valid[:, s]}"
        assert finite[:, s].all(), f"{name}: stream {s}: non-finite output pixels"
        assert ok[s] >= 0.9, f"{name}: stream {s}: tracker ok on {ok[s]:.3f} < 0.9 of frames"
        j_in, j_out = _jitter(poses[s], corr[:, s], delay)
        assert j_out < j_in, f"{name}: stream {s}: output jitter {j_out:.3f} px not below input {j_in:.3f}"
        jitter.append((j_in, j_out))
    tick_ms = max(gpu_ms, wall_ms)
    print(f"{name}: {STREAMS} x {n} 1080p frames in {n} batched ticks, valid from "
          f"tick {delay}, tracker ok on >= {ok.min():.3f} of frames per stream, jitter "
          + ", ".join(f"{a:.2f}->{b:.2f}" for a, b in jitter) + f" px, outputs "
          f"{out_spec.height}x{out_spec.width} in [{lo_all:.6f}, {hi_all:.6f}], launches {launches}",
          flush=True)
    print(f"{name}: {gpu_ms:.4f} ms/tick on the device, {wall_ms:.4f} ms/tick host wall "
          f"clock (last {_timed(n)} ticks); {gpu_ms / STREAMS:.4f} / {wall_ms / STREAMS:.4f} ms per "
          f"stream-frame; {1e3 * STREAMS / tick_ms:.1f} frames/s aggregate", flush=True)
    if profile_dir:
        _profile(multi.step, state, [frame(t) for t in range(5)], os.path.join(profile_dir, name))
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "jitter": jitter}


def run_multistream(dev, poses, clips, profile_dir: str | None) -> dict:
    """STREAMS flagship streams for N_FRAMES ticks: one batched warp (K2)
    and one LK launch (K3) a tick."""
    import livevisionkit_tpu_torch as lvk

    n = N_FRAMES
    return run_streams("multistream", lvk.flagship_filter(), dev, poses, clips, n,
                       _want(warp_batched=n, lk_track=n), profile_dir)


def run_chain_multistream(dev, poses, clips, profile_dir: str | None) -> dict:
    """STREAMS flagship streams, each through the stabilizer -> EASU 4K +
    RCAS 0.8 chain, for N_FRAMES ticks: one launch each of K2, K3, K5 and K6
    a tick, the scaler's kernels on their stream axis."""
    import livevisionkit_tpu_torch as lvk

    n = N_FRAMES
    chain = lvk.CompositeFilter((lvk.flagship_filter(), lvk.ScalingFilter(
        lvk.ScalingFilterSettings(output_size=OUT, sharpness=0.8))))
    return run_streams("chain_multistream", chain, dev, poses, clips, n,
                       _want(warp_batched=n, lk_track=n, easu_scale_batched=n, rcas_batched=n),
                       profile_dir)


def run_mesh_multistream(dev, poses, clips, profile_dir: str | None) -> dict:
    """STREAMS streams through the mesh stabilizer
    (`stabilization_preset(model="field")`) for MESH_TICKS ticks: one K2
    launch (on the meshes' dense maps) and one K3 launch a tick."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.presets import stabilization_preset

    n = MESH_TICKS
    filt = lvk.StabilizationFilter(settings=stabilization_preset(model="field"))
    return run_streams("mesh_multistream", filt, dev, poses, clips, n,
                       _want(warp_batched=n, lk_track=n), profile_dir)


def run_stream_multi(dev, clips) -> dict:
    """`stream_multi` end to end: STREAMS in-memory readers of host u8 BGR
    1080p frames (DRIVER_FRAMES each, from the clips) through the flagship
    filter on the card; every frame comes out, in order, with no stall."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import color
    from livevisionkit_tpu_torch.runtime.multistream import stream_multi

    yuv, bgr = lvk.PixelFormat.YUV, lvk.PixelFormat.BGR
    readers = []
    for s in range(STREAMS):
        frames = []
        for t in range(DRIVER_FRAMES):
            x = color.convert(clips[s, t].to(torch.float32) * (1.0 / 255.0), yuv, bgr)
            u8 = torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).permute(1, 2, 0)
            frames.append((u8.contiguous().cpu().numpy(), t / 30.0))
        readers.append(frames)
    got = [[] for _ in range(STREAMS)]
    bad = []

    def on_output(i, px, ts):  # each stream's writer thread appends to its own list
        if len(got[i]) % 10 == 0 and not (np.isfinite(px).all() and px.shape == (3, H, W)):
            bad.append((i, ts))
        got[i].append(ts)

    _reset_launches()
    t0 = time.perf_counter()
    stats = stream_multi(lvk.flagship_filter(), [iter(f) for f in readers], on_output=on_output,
                         device=dev)
    wall = time.perf_counter() - t0
    launches = _launches()
    total = STREAMS * DRIVER_FRAMES
    assert stats.frames_in == total and stats.frames_out == total, (
        f"frames in {stats.frames_in}, out {stats.frames_out}, want {total} each")
    assert stats.stalls == 0, f"{stats.stalls} stall bubbles"
    want = _want(warp_batched=stats.batches, lk_track=stats.batches)
    assert launches == want, f"kernel launches {launches}, want {want}"
    assert not bad, f"bad output frames {bad}"
    times = [float(np.float32(t / 30.0)) for t in range(DRIVER_FRAMES)]
    for i in range(STREAMS):
        assert got[i] == times, f"stream {i} timestamps {got[i]}"
    fps = total / wall
    print(f"stream_multi: {STREAMS} readers x {DRIVER_FRAMES} u8 BGR 1080p frames, {stats.batches} "
          f"batches, frames in {stats.frames_in} == out {stats.frames_out}, {stats.stalls} stalls, "
          f"per-stream order kept; {fps:.1f} frames/s aggregate over the whole run ({wall:.3f} s), "
          f"{stats.fps_aggregate:.1f} frames/s by the batch stopwatch", flush=True)
    return {"batches": stats.batches, "fps": fps, "fps_batches": stats.fps_aggregate}


def run_chain(dev, rng, profile_dir: str | None) -> dict:
    """60 1080p frames through the flagship stabilizer and the FSR scaler
    to 4K at sharpness 0.8 (the CLI's `vs,fsr.size=3840x2160` chain), then
    the scaler alone on the same frames."""
    import livevisionkit_tpu_torch as lvk

    out_size = OUT
    _, frames = _shaky_clip(dev, rng)
    n = len(frames)
    scaler = lvk.ScalingFilter(lvk.ScalingFilterSettings(output_size=out_size, sharpness=0.8))
    chain = lvk.CompositeFilter((lvk.flagship_filter(), scaler))
    delay = chain.delay
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    assert chain.output_spec(spec).height == out_size[0]
    chain.step(chain.init(spec, device=dev), frames[0])
    state = chain.init(spec, device=dev)
    torch.cuda.synchronize()

    # Per frame only 0-d flags and extrema are kept (no 4K output outlives
    # its step).
    valids, finite, lo, hi = [], [], [], []

    def keep(t, st, out):
        assert out.pixels.shape == (3, *out_size), tuple(out.pixels.shape)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).all())
        lo.append(out.pixels.amin())
        hi.append(out.pixels.amax())

    _reset_launches()
    state, gpu_ms, wall_ms = _drive(chain, state, frames, keep)
    launches = _launches()

    want = _want(warp=n, lk_track=n, easu_scale=n, rcas=n)
    assert launches == want, f"kernel launches {launches}, want {want}"
    valid = [bool(v) for v in valids]
    assert valid == [t >= delay for t in range(n)], f"valid flags {valid}"
    bad = [t for t, f in enumerate(finite) if not bool(f)]
    assert not bad, f"non-finite output pixels in frames {bad}"
    lo_all, hi_all = min(float(v) for v in lo), max(float(v) for v in hi)
    # EASU de-rings into its 4 nearest taps and RCAS's limiter keeps [0, 1]
    # input inside [0, 1].
    assert -1e-5 <= lo_all and hi_all <= 1.0 + 1e-5, f"outputs span [{lo_all}, {hi_all}]"
    print(f"chain: {n} frames 1080p -> stabilizer -> EASU 4K + RCAS 0.8, valid from frame "
          f"{delay}, outputs in [{lo_all:.6f}, {hi_all:.6f}], launches {launches}", flush=True)
    print(f"chain: {gpu_ms:.4f} ms/frame on the device (CUDA events over the last {N_TIMED} "
          f"frames), {wall_ms:.4f} ms/frame host wall clock", flush=True)
    if profile_dir:
        _profile(chain.step, state, frames, os.path.join(profile_dir, "chain"))

    _reset_launches()
    _, sc_gpu_ms, sc_wall_ms = _drive(scaler, (), frames, lambda t, st, out: None)
    sc_launches = _launches()
    assert sc_launches == _want(easu_scale=n, rcas=n), sc_launches
    print(f"scaler alone: 1080p -> 4K EASU + RCAS 0.8, {sc_gpu_ms:.4f} ms/frame on the device, "
          f"{sc_wall_ms:.4f} ms/frame host wall clock (last {N_TIMED} of {n} frames)", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
            "scaler_gpu_ms": sc_gpu_ms, "scaler_wall_ms": sc_wall_ms, "scaler_launches": sc_launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from livevisionkit_tpu_torch.ops.cuda_kernels import build

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"nvcc: {_nvcc_line()}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    for r in build.resources():
        print(f"ptxas {r['kernel']}: {r['registers']} registers, {r['smem']} B shared memory, "
              f"{r['stack']} B stack, {r['spill_stores']} / {r['spill_loads']} B spilled "
              f"(stores / loads)", flush=True)

    rng = np.random.default_rng(0)
    warp_rep = check_warp(dev, rng)
    warp_b_rep = check_warp_batched(dev, rng)
    lk_rep = check_lk(dev, rng)
    lk_b_rep = check_lk_batched(dev, rng)
    easu_rep = check_easu_scale(dev, rng)
    easu_b_rep = check_easu_scale_x8(dev, rng)
    rcas_rep = check_rcas(dev, rng)
    rcas_b_rep = check_rcas_x8(dev, rng)
    poses, clips = _shaky_clips_u8(dev, rng)
    # The solo step and the 8-stream tick alternate, since the host's pace
    # wanders between phases of one process.
    pairs = []
    for k in range(2):
        profile = args.profile if k == 0 else None
        pairs.append((run_slice(dev, rng, profile), run_multistream(dev, poses, clips, profile)))
    for k, (a, b) in enumerate(pairs):
        print(f"pair {k + 1}: solo step {a['gpu_ms']:.4f} / {a['wall_ms']:.4f} ms/frame; "
              f"{STREAMS}-stream tick {b['gpu_ms']:.4f} / {b['wall_ms']:.4f} ms/tick = "
              f"{b['gpu_ms'] / STREAMS:.4f} / {b['wall_ms'] / STREAMS:.4f} ms per stream-frame "
              f"(device / host)", flush=True)
    sl, ms = pairs[0]
    ch = run_chain(dev, rng, args.profile)
    chx = run_chain_multistream(dev, poses, clips, args.profile)
    me = run_mesh(dev, rng, args.profile)
    mex = run_mesh_multistream(dev, poses, clips, args.profile)
    sm = run_stream_multi(dev, clips)
    del clips

    def entry(name, source, replaces, launches, rep, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"livevisionkit_tpu_torch/csrc/{source}",
                "replaces": f"livevisionkit_tpu/ops/tpu_kernels/{replaces}", "launches": launches,
                "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"], "library_ms": library_ms}

    def launched(kernel, *paths):
        return sum(r["launches"][kernel] for r in paths)

    # Launches: the kernel's count over every path that launches it (the
    # scaler alone is part of the chain's report).  No single PyTorch call
    # computes the EASU warp or upscale, LK or RCAS: library_ms is null; the
    # bilinear warp's grid_sample time is printed above.
    paths = (sl, ms, ch, chx, me, mex)
    easu_2x = dict(easu_rep[OUT], max_abs_err=max(r["max_abs_err"] for r in easu_rep.values()))
    kernels = [
        entry("warp", "warp.cu", "warp.py:312", launched("warp", *paths), warp_rep["easu"]),
        entry("warp_batched", "warp.cu", "warp.py:829", launched("warp_batched", *paths),
              warp_b_rep["easu"]),
        entry("lk_track", "lk.cu", "lk.py:255", launched("lk_track", sl, ch, me), lk_rep["lk_track"]),
        entry("lk_track_x8", "lk.cu", "lk.py:255", launched("lk_track", ms, chx, mex), lk_b_rep),
        # K4 is K3's n_levels = 1 call.
        entry("lk_level", "lk.cu", "lk.py:201", launched("lk_level", *paths), lk_rep["lk_level"]),
        entry("easu_scale", "easu_scale.cu", "easu_scale.py:264",
              launched("easu_scale", *paths) + ch["scaler_launches"]["easu_scale"], easu_2x),
        entry("easu_scale_x8", "easu_scale.cu", "easu_scale.py:264",
              launched("easu_scale_batched", *paths), easu_b_rep),
        entry("rcas", "rcas.cu", "rcas.py:108",
              launched("rcas", *paths) + ch["scaler_launches"]["rcas"], rcas_rep),
        entry("rcas_x8", "rcas.cu", "rcas.py:108", launched("rcas_batched", *paths), rcas_b_rep),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{gpu} | slice {sl['gpu_ms']:.4f} ms/frame (device), {sl['wall_ms']:.4f} ms/frame (host)"
          f" | {STREAMS}-stream tick {ms['gpu_ms']:.4f} / {ms['wall_ms']:.4f} ms"
          f" | chain {ch['gpu_ms']:.4f} / {ch['wall_ms']:.4f} | scaler alone "
          f"{ch['scaler_gpu_ms']:.4f} / {ch['scaler_wall_ms']:.4f}"
          f" | {STREAMS}-stream chain tick {chx['gpu_ms']:.4f} / {chx['wall_ms']:.4f}"
          f" | mesh {me['gpu_ms']:.4f} / {me['wall_ms']:.4f}"
          f" | {STREAMS}-stream mesh tick {mex['gpu_ms']:.4f} / {mex['wall_ms']:.4f}"
          f" | stream_multi {sm['fps']:.1f} frames/s | K3 x{STREAMS} {lk_b_rep['ms']:.4f} ms"
          f" | K5 x{STREAMS} {easu_b_rep['ms']:.4f} ms | K6 x{STREAMS} {rcas_b_rep['ms']:.4f} ms",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
