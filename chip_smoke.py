"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch version on the card at the shapes of the main paths, then drives
two paths over 60-frame synthetic shaky 1080p clips rendered on the card:
the flagship stabilizer (`livevisionkit_tpu_torch.flagship_filter`) alone,
and the chain stabilizer -> FSR scaler to 4K (`CompositeFilter` of it and
`ScalingFilter`), checking that each step went through its kernels once
per frame and that the outputs are right.  It also times the scaler alone
at 1080p -> 4K.  Every failure raises.  The last line is a JSON object
with the device; the line before it lists each kernel's launches, error
and times.  With no CUDA device it exits non-zero and prints no result.
`--profile DIR` also writes torch.profiler tables of five steady steps of
each path to DIR.
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
# (a 3/2 ratio, config.py's ScalingFilterSettings) and one fallback ratio.
SCALE_CASES = (((H, W), OUT), ((720, 1280), (H, W)), ((H, W), (1600, 2844)))
N_FRAMES, N_TIMED = 60, 40
RUNS = 20


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


def _median_ms(fn, runs: int = RUNS) -> float:
    """Median of `runs` CUDA-event timings of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def _kernel_modules():
    from livevisionkit_tpu_torch.ops.cuda_kernels import easu_scale, lk, rcas, warp

    return {"warp": warp.warp, "lk_track": lk.lk_track, "easu_scale": easu_scale.easu_scale,
            "rcas": rcas.rcas}


def _reset_launches() -> None:
    for fn in _kernel_modules().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_modules().items()}


def _shaky_clip(dev, rng):
    """60 frames of a 1080p YUV shaky camera path over a texture larger
    than the frame: slow drift + per-frame jitter (px, rad).  Returns the
    frame -> texture poses and the frames."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops

    tex = torch.from_numpy(_texture(H + 320, W + 320, rng)).to(dev)[None].contiguous()
    n = N_FRAMES
    tx = 100.0 + 1.0 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ty = 100.0 + 0.5 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ang = rng.uniform(-0.003, 0.003, n)
    poses = [_similarity(1.0, ang[t], tx[t], ty[t], dev) for t in range(n)]
    frames = []
    for t, p in enumerate(poses):
        y = remap_ops.remap(tex, p.sample_map((H, W), inverse=False), fill=0.5, filter_mode="bilinear")
        px = torch.cat([y, torch.full((2, H, W), 0.5, device=dev)]).contiguous()
        frames.append(lvk.Frame.create(px, timestamp=t / 30.0, fmt=lvk.PixelFormat.YUV))
    torch.cuda.synchronize()
    return poses, frames


def _profile(step, state, frames, path: str) -> None:
    """torch.profiler table and trace of five steady steps."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fr in frames[:5]:
            state, _ = step(state, fr)
        torch.cuda.synchronize()
    with open(path + "_profile.txt", "w") as fh:
        fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    prof.export_chrome_trace(path + "_trace.json")


def check_warp(dev, rng) -> dict:
    """K1 against its plain version at 1080x1920x3 under a stabilization-
    scale similarity whose corner leaves the frame (fill + nearest ring)."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    img_f = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
    img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.01, math.radians(0.5), 12.0, -7.0, dev).sample_map((H, W)).contiguous()
    n_out = float(((smap[0] < 0) | (smap[0] > H - 1) | (smap[1] < 0) | (smap[1] > W - 1)).sum())
    assert n_out > 1000, f"the map must leave the frame somewhere ({n_out} px do)"
    report = {}
    for mode in ("easu", "bilinear"):
        kf = warp_kernel.warp(img_f, smap, fill=0.0, filter_mode=mode)
        pf = remap_ops.remap_plain(img_f, smap, fill=0.0, filter_mode=mode)
        err_f = float((kf - pf).abs().max())
        assert err_f <= 1e-4, f"{mode} f32 warp differs from plain by {err_f} > 1e-4"
        ku = warp_kernel.warp(img_u8, smap, fill=0.0, filter_mode=mode)
        pu = remap_ops.remap_plain(img_u8, smap, fill=0.0, filter_mode=mode)
        d = (ku.int() - pu.int()).abs()
        max_lsb, frac = int(d.max()), float((d > 0).float().mean())
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"{mode} u8 warp: max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
        ms = _median_ms(lambda: warp_kernel.warp(img_u8, smap, fill=0.0, filter_mode=mode))
        plain_ms = _median_ms(lambda: remap_ops.remap_plain(img_u8, smap, fill=0.0, filter_mode=mode))
        print(f"K1 warp {mode}: f32 max|err| {err_f:.3e}; u8 max {max_lsb} LSB on "
              f"{frac:.2e} of pixels; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(u8 3x{H}x{W}, median of {RUNS})", flush=True)
        report[mode] = {"max_abs_err": max_lsb, "ms": ms, "plain_ms": plain_ms, "f32_err": err_f}
    return report


def check_lk(dev, rng) -> dict:
    """K3 against its plain version on a 3-level 272x480 pyramid with the
    flagship's 510 grid features, on a shifted and rotated texture."""
    from livevisionkit_tpu_torch.config import FeatureDetectorSettings, OpticalFlowSettings
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
    from livevisionkit_tpu_torch.vision import features, optical_flow

    size = (272, 480)
    tex = torch.from_numpy(_texture(400, 640, rng)).to(dev)
    f0 = remap_ops.remap_plain(tex, _similarity(1.0, 0.0, 60.0, 50.0, dev).sample_map(size, inverse=False), fill=0.5)
    f1 = remap_ops.remap_plain(
        tex, _similarity(1.0, math.radians(0.6), 62.5, 48.8, dev).sample_map(size, inverse=False), fill=0.5)
    det = FeatureDetectorSettings()
    feats, _ = features.detect(f0, features.initial_thresholds(det, dev), det)
    assert feats.points.shape == (510, 2)
    flow_s = OpticalFlowSettings()
    p0 = optical_flow.Pyramid.build(f0, flow_s.pyramid_levels)
    p1 = optical_flow.Pyramid.build(f1, flow_s.pyramid_levels)
    pts = feats.points.contiguous()
    zero = torch.zeros_like(pts)
    args = (p0.levels, p1.levels, pts, zero, flow_s.window_size, flow_s.iterations,
            flow_s.min_eigen_threshold)
    kflow, kgood = lk_kernel.lk_track(*args)
    pflow, pgood = optical_flow.track_plain(p0, p1, pts, flow_s)
    valid = feats.valid
    both = kgood & pgood & valid
    assert int(both.sum()) >= 100, f"too few features tracked by both ({int(both.sum())})"
    err = float((kflow - pflow)[both].abs().max())
    agree = float((kgood == pgood)[valid].float().mean())
    assert err <= 1e-3, f"LK flow differs from plain by {err} px > 1e-3"
    assert agree >= 0.99, f"LK tracked masks agree on {agree:.4f} < 0.99 of features"
    ms = _median_ms(lambda: lk_kernel.lk_track(*args))
    plain_ms = _median_ms(lambda: optical_flow.track_plain(p0, p1, pts, flow_s))
    print(f"K3 lk_track: max|flow err| {err:.3e} px over {int(both.sum())} features, masks "
          f"agree on {agree:.4f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(3 levels of 272x480, 510 features, median of {RUNS})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
        ms = _median_ms(lambda: easu_ops.easu_scale(img, size, PixelFormat.YUV))
        plain_ms = _median_ms(lambda: easu_ops.easu_scale_plain(img, size, PixelFormat.YUV))
        form = "rational" if plan.rational else "fallback"
        print(f"K5 easu_scale 3x{h}x{w} -> {size[0]}x{size[1]} ({form} {plan.py}/{plan.qy}, "
              f"{plan.px}/{plan.qx}): max|err| {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (f32, median of {RUNS})", flush=True)
        report[size] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return report


def check_rcas(dev, rng) -> dict:
    """K6 against its plain version on the chain's 3x2160x3840 f32 frame
    (a 4K EASU upscale of a texture) at sharpness 0.8."""
    from livevisionkit_tpu_torch.ops import easu as easu_ops
    from livevisionkit_tpu_torch.ops import rcas as rcas_ops

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    small = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
    img = easu_ops.easu_scale_plain(small, OUT).contiguous()
    got = rcas_ops.rcas(img, 0.8)
    want = rcas_ops.rcas_plain(img, 0.8)
    err = float((got - want).abs().max())
    moved = float((got - img).abs().max())
    del got, want
    assert err <= 1e-6, f"rcas differs from plain by {err} > 1e-6"
    assert moved > 1e-3, f"rcas changed no pixel by more than {moved}"
    ms = _median_ms(lambda: rcas_ops.rcas(img, 0.8))
    plain_ms = _median_ms(lambda: rcas_ops.rcas_plain(img, 0.8))
    print(f"K6 rcas 3x{OUT[0]}x{OUT[1]}: max|err| {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(f32, sharpness 0.8, median of {RUNS})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _drive(filt, state, frames, per_frame):
    """Step `filt` over `frames` with synchronizing calls made errors; return
    the state, device ms/frame (CUDA events) and host ms/frame over the
    last N_TIMED frames.  `per_frame(t, state, out)` keeps what is checked."""
    n = len(frames)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall0 = 0.0
    # The step must never wait for the device (that is what lets it be
    # captured in a CUDA graph): any synchronizing call in it raises here.
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t, fr in enumerate(frames):
            if t == n - N_TIMED:
                start.record()
                wall0 = time.perf_counter()
            state, out = filt.step(state, fr)
            per_frame(t, state, out)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - wall0) * 1e3 / N_TIMED
    return state, start.elapsed_time(end) / N_TIMED, wall_ms


def run_slice(dev, rng, profile_dir: str | None) -> dict:
    """60 flagship 1080p frames through the stabilizer on the card."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils import metrics

    poses, frames = _shaky_clip(dev, rng)
    n = len(frames)
    filt = lvk.flagship_filter()
    delay = filt.delay  # output lag in frames (the predictive window)
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    # One step on a throwaway state fills the per-shape caches (the resize
    # weights), so the measured run below meets no first-use work.
    filt.step(filt.init(spec, device=dev), frames[0])
    state = filt.init(spec, device=dev)
    torch.cuda.synchronize()

    # Per frame, only 0-d flags and the 2x2 correction are kept: holding
    # every 1080p output would make the allocator take fresh device memory
    # each step, which a streaming consumer never pays.
    valids, finite, corrections, stabilities = [], [], [], []

    def keep(t, st, out):
        assert out.pixels.shape == (3, H, W)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).all())
        corrections.append(st.correction)
        stabilities.append(st.stability)

    _reset_launches()
    state, gpu_ms, wall_ms = _drive(filt, state, frames, keep)
    launches = _launches()

    want = {"warp": n, "lk_track": n, "easu_scale": 0, "rcas": 0}
    assert launches == want, f"kernel launches {launches}, want {want}"
    valid = [bool(v) for v in valids]
    assert valid == [t >= delay for t in range(n)], f"valid flags {valid}"
    bad = [t for t, f in enumerate(finite) if not bool(f)]
    assert not bad, f"non-finite output pixels in frames {bad}"
    ok = [float(s) > 0.0 for s in stabilities[1:]]
    ok_frac = sum(ok) / len(ok)
    assert ok_frac >= 0.9, f"tracker ok on {ok_frac:.3f} < 0.9 of frames"

    # A scene point's path in the input and the output: input x_t =
    # P_t^-1(s); the output at step t shows frame t - delay, corrected, so
    # the point sits at H_c(x) with H_c the correction's homography.
    s = torch.tensor([[W / 2 + 160.0, H / 2 + 160.0]], device=dev)
    x_in, y_out = [], []
    for t in range(delay, n):
        x = poses[t - delay].inverse().transform(s)
        x_in.append(x[0].cpu().numpy())
        y_out.append(corrections[t].to_homography((H, W)).transform(x)[0].cpu().numpy())
    j_in, j_out = metrics.jitter(np.array(x_in)), metrics.jitter(np.array(y_out))
    assert j_out < j_in, f"output jitter {j_out:.3f} px not below input {j_in:.3f} px"
    print(f"slice: {n} flagship 1080p frames, valid from frame {delay}, tracker ok on "
          f"{ok_frac:.3f} of frames, jitter {j_in:.3f} -> {j_out:.3f} px, launches {launches}",
          flush=True)
    print(f"slice: {gpu_ms:.4f} ms/frame on the device (CUDA events over the last {N_TIMED} "
          f"frames), {wall_ms:.4f} ms/frame host wall clock", flush=True)
    if profile_dir:
        _profile(filt.step, state, frames, os.path.join(profile_dir, "slice"))
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
            "jitter_in": j_in, "jitter_out": j_out}


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

    want = {"warp": n, "lk_track": n, "easu_scale": n, "rcas": n}
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
    assert sc_launches == {"warp": 0, "lk_track": 0, "easu_scale": n, "rcas": n}, sc_launches
    print(f"scaler alone: 1080p -> 4K EASU + RCAS 0.8, {sc_gpu_ms:.4f} ms/frame on the device, "
          f"{sc_wall_ms:.4f} ms/frame host wall clock (last {N_TIMED} of {n} frames)", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
            "scaler_gpu_ms": sc_gpu_ms, "scaler_wall_ms": sc_wall_ms}


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

    rng = np.random.default_rng(0)
    warp_rep = check_warp(dev, rng)
    lk_rep = check_lk(dev, rng)
    easu_rep = check_easu_scale(dev, rng)
    rcas_rep = check_rcas(dev, rng)
    sl = run_slice(dev, rng, args.profile)
    ch = run_chain(dev, rng, args.profile)

    kernels = [
        {"name": "warp", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/warp.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/warp.py:312",
         "launches": sl["launches"]["warp"], "max_abs_err": warp_rep["easu"]["max_abs_err"],
         "ms": warp_rep["easu"]["ms"], "plain_ms": warp_rep["easu"]["plain_ms"]},
        {"name": "lk_track", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/lk.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/lk.py:255",
         "launches": sl["launches"]["lk_track"], "max_abs_err": lk_rep["max_abs_err"],
         "ms": lk_rep["ms"], "plain_ms": lk_rep["plain_ms"]},
        {"name": "easu_scale", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/easu_scale.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/easu_scale.py:264",
         "launches": ch["launches"]["easu_scale"],
         "max_abs_err": max(r["max_abs_err"] for r in easu_rep.values()),
         "ms": easu_rep[OUT]["ms"], "plain_ms": easu_rep[OUT]["plain_ms"]},
        {"name": "rcas", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/rcas.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/rcas.py:108",
         "launches": ch["launches"]["rcas"], "max_abs_err": rcas_rep["max_abs_err"],
         "ms": rcas_rep["ms"], "plain_ms": rcas_rep["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{gpu} | slice {sl['gpu_ms']:.4f} ms/frame (device), {sl['wall_ms']:.4f} ms/frame (host)"
          f" | chain {ch['gpu_ms']:.4f} / {ch['wall_ms']:.4f} | scaler alone "
          f"{ch['scaler_gpu_ms']:.4f} / {ch['scaler_wall_ms']:.4f}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
