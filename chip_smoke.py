"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch version on the card at the flagship shapes, then drives the
flagship 1080p stabilizer (`livevisionkit_tpu_torch.flagship_filter`) over a
60-frame synthetic shaky clip rendered on the card, and checks that the
step went through both kernels once per frame and stabilized the clip.
Every failure raises.  The last line is a JSON object with the device; the
line before it lists each kernel's launches, error and times.  With no CUDA
device it exits non-zero and prints no result.  `--profile DIR` also writes
a torch.profiler table of five steady steps to DIR.
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


def run_slice(dev, rng, profile_dir: str | None) -> dict:
    """60 flagship 1080p frames through the port on the card."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
    from livevisionkit_tpu_torch.utils import metrics

    # Shaky camera path: slow drift + per-frame jitter (px, rad), frame ->
    # texture poses over a texture larger than the frame.
    tex = torch.from_numpy(_texture(H + 320, W + 320, rng)).to(dev)[None].contiguous()
    n = N_FRAMES
    tx = 100.0 + 1.0 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ty = 100.0 + 0.5 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ang = rng.uniform(-0.003, 0.003, n)
    poses = [_similarity(1.0, ang[t], tx[t], ty[t], dev) for t in range(n)]
    clip = []
    for p in poses:
        y = remap_ops.remap(tex, p.sample_map((H, W), inverse=False), fill=0.5, filter_mode="bilinear")
        clip.append(torch.cat([y, torch.full((2, H, W), 0.5, device=dev)]).contiguous())
    torch.cuda.synchronize()

    filt = lvk.flagship_filter()
    delay = filt.delay  # output lag in frames (the predictive window)
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    frames = [lvk.Frame.create(c, timestamp=t / 30.0, fmt=lvk.PixelFormat.YUV) for t, c in enumerate(clip)]
    # One step on a throwaway state fills the per-shape caches (the resize
    # weights), so the measured run below meets no first-use work.
    filt.step(filt.init(spec, device=dev), frames[0])
    state = filt.init(spec, device=dev)
    torch.cuda.synchronize()

    warp_kernel.warp.launches = 0
    lk_kernel.lk_track.launches = 0
    # Per frame, only 0-d flags and the 2x2 correction are kept: holding
    # every 1080p output would make the allocator take fresh device memory
    # each step, which a streaming consumer never pays.
    valids, finite, corrections, stabilities = [], [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall0 = 0.0
    # The step must never wait for the device (that is what lets it be
    # captured in a CUDA graph): any synchronizing call in it raises here.
    torch.cuda.set_sync_debug_mode("error")
    for t, fr in enumerate(frames):
        if t == n - N_TIMED:
            start.record()
            wall0 = time.perf_counter()
        state, out = filt.step(state, fr)
        assert out.pixels.shape == (3, H, W)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).all())
        corrections.append(state.correction)
        stabilities.append(state.stability)
    end.record()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - wall0) * 1e3 / N_TIMED
    launches = {"warp": warp_kernel.warp.launches, "lk_track": lk_kernel.lk_track.launches}
    gpu_ms = start.elapsed_time(end) / N_TIMED

    assert launches == {"warp": n, "lk_track": n}, f"kernel launches {launches}, want {n} each"
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
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fr in frames[:5]:
                state, out = filt.step(state, fr)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "slice_profile.txt"), "w") as fh:
            fh.write(table)
        prof.export_chrome_trace(os.path.join(profile_dir, "slice_trace.json"))
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
            "jitter_in": j_in, "jitter_out": j_out}


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
    sl = run_slice(dev, rng, args.profile)

    kernels = [
        {"name": "warp", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/warp.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/warp.py:312",
         "launches": sl["launches"]["warp"], "max_abs_err": warp_rep["easu"]["max_abs_err"],
         "ms": warp_rep["easu"]["ms"], "plain_ms": warp_rep["easu"]["plain_ms"]},
        {"name": "lk_track", "route": "cuda", "source": "livevisionkit_tpu_torch/csrc/lk.cu",
         "replaces": "livevisionkit_tpu/ops/tpu_kernels/lk.py:255",
         "launches": sl["launches"]["lk_track"], "max_abs_err": lk_rep["max_abs_err"],
         "ms": lk_rep["ms"], "plain_ms": lk_rep["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{gpu} | slice {sl['gpu_ms']:.4f} ms/frame (device), {sl['wall_ms']:.4f} ms/frame (host)",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
