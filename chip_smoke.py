"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written kernels from csrc/ (printing each one's registers,
shared memory and spills from ptxas), holds each against its plain
PyTorch version on the card at the shapes of the main paths (the warp
solo and batched over 8 streams, also under maps whose blocks exceed the
warp's shared-memory box, in EASU and bilinear mode, with each mode's
staged and device-memory block counts, LK solo, over 8 streams and with one level,
which is K4, the EASU upscale and RCAS solo and over 8 streams at the
chain tick's 1080p -> 4K shapes, each batched launch bit-equal to 8 solo
launches and to them at stream stride 0, RCAS beside a clone of its
frame, and an empty kernel as the floor of every launch's time), RANSAC +
IRLS (K7) at the flagship's 510 features and 256 hypotheses, solo and
over 8 streams in one launch, against its plain version, the deblocker's
kernels (K8: the 5 x 5 median alone at the 4K pooled 3x540x960, the
reduce + blend pair at 3x2160x3840) against theirs, CAS (K9) at
3x2160x3840 and over 8 streams at 1080p, bit-equal to its plain version
(the batched launch also to 8 solo launches and at stream stride 0), then
drives the paths over synthetic shaky 1080p clips rendered on the card:
the flagship stabilizer (`livevisionkit_tpu_torch.flagship_filter`)
alone; 8 streams of it in one batched step (`MultiStreamFilter`),
alternated twice with the solo stabilizer; the chain stabilizer -> FSR
scaler to 4K (`CompositeFilter` of it and `ScalingFilter`), solo and over
8 streams; the stabilizer in mesh mode
(`presets.stabilization_preset(model="field")`, a 16x16 mesh), solo, with
the warp kernel checked on its dense sample map, and over 8 streams; and
the multi-stream driver `stream_multi` over 8 in-memory 1080p BGR readers.
Then the serving tools (tools/bench_*_torch.py, called in-process) at 8 x
1080p: the loopback (a slow stream's stall bubbles and an early-EOF
stream's drain ticks through the tick's graph), a soak of back-to-back
sessions (no frame lost, no deadlock, host and device memory bounded),
`stream_multi` end to end against 480 frames/s with the transfer floor,
stream scaling at S = 1, 2, 4, 8 against 0.8 efficiency, and `stream()`'s
latency at a paced 60 fps, identity and flagship, with and without the
in-flight window.
Then the bench and profiling tools: first the seven configs of the
BASELINE.md ladder that no other phase runs (640x480 GRAY; the bilinear
homography and mesh stabilizers at 1080p; the homography and mesh
stabilizers at 4K, EASU and bilinear), each over a shaky clip as a graph
bit-equal to its op-by-op step, and K1 at their shapes against plain;
then, in-process at full width, bench_torch.py, the 14 configs of
tools/bench_matrix_torch.py, the stage splits of
tools/profile_{stages,tracker,enhance,serving_stages}_torch.py (the
tracker at S = 1 and 8 and in mesh mode) and tools/profile_warp_torch.py
(the warp whole, its map and its kernel, K2 at S = 1, 2, 4, 8 against S
solo launches, EASU and bilinear, u8 and f32), each row finite, above an
empty kernel's time and under the JAX tool's name, on a line with the
card's name and power limit, and the warp.apply split into map, kernel
and the rest.
Then the enhancement filters: the warp at four planes (colour + alpha,
solo and over 8 streams) against its plain version; the 4K full chain
(the mesh stabilizer, `DeblockingFilter` and `CASFilter` over a shaky
2160x3840 clip with a blocky region); the deblocker at 1080p and 4K and
CAS at 4K alone, each against the same op on a CPU copy; the 8-stream
`vs + adb + cas` tick at 1080p; and the stabilizer's debug overlays on
frames with alpha, solo beside the plain filter and over 8 streams.
Then the runtime slice at 1080p, fed from in-memory readers (the script
needs no OpenCV): the `lvk-torch` chain `-f lc.profile=... -f
vs.crop_out=1 -f adb` (built by the CLI's own filter registry) through
`runtime/stream.stream`, with synchronizing calls made errors around the
run, then with per-filter profiling, the frame-time HUD and a
`DeviceTrace`; `LensCorrectionFilter` alone in EASU and bilinear mode (K1
on its undistort map against plain, at three and four planes, beside
F.grid_sample); `process_clip` bit-equal to the frame loop; the ingest
codecs against the CPU codecs and the native host library; a flagship
and a mesh snapshot each resumed bit-equal; and a chessboard calibration
of a known camera.
Then the multi-device slice, on a mesh of the host's cards when it has
four, else of cuda:0 repeated: the tile-sharded 4K halo remap (K1 once a
tile, against solo K1 and each tile against plain), `process_clip_sharded`
of 192 1080p frames in four chunks against `process_clip`, the
feature-sharded mesh solve against the solo one, `dryrun_multichip(4)` at
1080p and 4K, and two processes of tools/run_multiproc_torch.py.
Each path's step is also driven compiled, as a CUDA graph captured once
and replayed a frame (utils/compiled.jit_step, the JAX package's
`jax.jit(step, donate_argnums=0)`): the solo, 8-stream, chain, chain
tick, mesh, mesh tick, 4K full chain and `vs + adb + cas` tick steps and
the `lvk-torch` chain's step (`run_graph`: in lockstep with the op-by-op
step, every output and correction bit-equal, the mesh paths' too, since
the mesh solve sums in a fixed order, the kernels' launches
counted at the capture and none after, then timed, then traced: each
kernel of the path once a replay by its name in the profiler's trace),
and `stream()`, `stream_multi`, `process_clip` and `process_clip_sharded`
(their default) and the dry run, each bit-equal to its op-by-op run.  A
step that synchronizes raises at its first call and makes no graph.
Each drive checks that its step went through its kernels once per frame
(or tick) and that the outputs are right.  It also times the scaler alone
at 1080p -> 4K.  Every failure raises.  The last line is a JSON object
with the device; the line before it gives the card's name and power limit
and each path's ms per step op by op and as a graph (device / host), the
line before that the card's name again with each path's op-by-op ms per
step, and the line before that lists each kernel's
launches over every path, error and times, with its bound (the larger of
its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, the H100
SXM's published peaks, counted from this run's shapes and maps) and the
time of one PyTorch call computing the same function where there is one
(F.grid_sample for the bilinear warp; none computes EASU, LK, RCAS or CAS).
Kernel times are taken behind a device spin, so the host's enqueue gap is
not in them; the text lines give each
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


def _cas_ops(nc: int, h: int, w: int) -> int:
    """f32 operations of CAS (csrc/cas.cu), every pixel and channel: 18
    min/max and 2 adds for the soft min and max, 7 for the amp (a
    subtraction, a min, a max, a division, the clamp's two and the square
    root) and 11 for the weight, the cross's sum, the blend, its division
    and the clamp."""
    return 36 * nc * h * w


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
    K3's stream axis is the same wrapper, counted by the path that calls it;
    K2's bilinear launches are counted apart too, and are also in its
    count; a `deblock` call is K8's two launches, the reduce and the
    blend)."""
    from livevisionkit_tpu_torch.ops.cuda_kernels import cas, deblock, easu_scale, lk, ransac, rcas, warp

    return {"warp": (warp.warp, "launches"), "warp_batched": (warp.warp_batched, "launches"),
            "warp_batched_bilinear": (warp.warp_batched, "launches_bilinear"),
            "lk_track": (lk.lk_track, "launches"), "lk_level": (lk.lk_track, "launches_one_level"),
            "easu_scale": (easu_scale.easu_scale, "launches"),
            "easu_scale_batched": (easu_scale.easu_scale_batched, "launches"),
            "rcas": (rcas.rcas, "launches"), "rcas_batched": (rcas.rcas_batched, "launches"),
            "ransac": (ransac.ransac_estimate, "launches"),
            "median_blur": (deblock.median_blur, "launches"), "deblock": (deblock.deblock, "launches"),
            "cas": (cas.cas, "launches"), "cas_batched": (cas.cas_batched, "launches")}


def _want(**launches) -> dict:
    """Every kernel's expected launch count: those named, the rest 0.  The
    tracker runs K7 (RANSAC, solo or batched) once wherever it runs K3, so
    `ransac` defaults to `lk_track`'s count."""
    launches.setdefault("ransac", launches.get("lk_track", 0))
    return {name: launches.get(name, 0) for name in _counters()}


def _reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _shaky_render(dev, rng, size=(H, W), n=N_FRAMES):
    """An n-frame YUV shaky camera path (60 frames at 1080p by default) over
    a texture larger than the frame: slow drift + per-frame jitter (px,
    rad).  Returns the frame -> texture poses and a function rendering
    frame t's (3, h, w) pixels."""
    from livevisionkit_tpu_torch.ops import remap as remap_ops

    h, w = size
    tex = torch.from_numpy(_texture(h + 320, w + 320, rng)).to(dev)[None].contiguous()
    tx = 100.0 + 1.0 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ty = 100.0 + 0.5 * np.arange(n) + rng.uniform(-6.0, 6.0, n)
    ang = rng.uniform(-0.003, 0.003, n)
    poses = [_similarity(1.0, ang[t], tx[t], ty[t], dev) for t in range(n)]

    def pixels(t):
        y = remap_ops.remap(tex, poses[t].sample_map((h, w), inverse=False), fill=0.5,
                            filter_mode="bilinear")
        return torch.cat([y, torch.full((2, h, w), 0.5, device=dev)]).contiguous()

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


def _traced_kernels(prof, path: str) -> list[tuple[float, float]]:
    """(start, end) in us of every device kernel of a profiler run, from
    its chrome trace written to `path`, in order of start."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in json.load(fh)["traceEvents"]
                      if e.get("cat") == "kernel")


def _busy_us(kernels: list[tuple[float, float]]) -> float:
    """The union of the kernel intervals, in us."""
    busy, end = 0.0, kernels[0][0] if kernels else 0.0
    for start, stop in kernels:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


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
    kernels = _traced_kernels(prof, path + "_trace.json")
    if not kernels:
        print(f"profile {os.path.basename(path)}: no device kernels traced", flush=True)
        return
    busy = _busy_us(kernels)
    span = max(stop for _, stop in kernels) - kernels[0][0]
    n = len(steps)
    print(f"profile {os.path.basename(path)}: {len(kernels) / n:.1f} kernel launches per step, "
          f"{busy / n / 1e3:.4f} ms device busy per step, {100.0 * (1.0 - busy / span):.1f}% of "
          f"the traced span idle", flush=True)


# ------------------------------------------------------------------------
# The compiled step: a path's step captured as a CUDA graph and replayed
# (utils/compiled.jit_step), against the same step op by op.

GRAPH_TRACE_STEPS = 5  # replays traced by the profiler
# Each kernel's name in a profiler trace and the launch counters it
# answers to (K2 is K1's kernel over a stream grid, K4 K3's with one level).
TRACE_GROUPS = {
    "K1/K2": (r"(easu|bilinear)_warp_kernel", ("warp", "warp_batched")),
    "K3/K4": (r"lk_kernel", ("lk_track", "lk_level")),
    "K5": (r"easu_scale_kernel", ("easu_scale", "easu_scale_batched")),
    "K6": (r"rcas_kernel", ("rcas", "rcas_batched")),
    "K7": (r"ransac_kernel", ("ransac",)),
    "K8 reduce": (r"deblock_reduce_kernel", ("deblock",)),
    "K8 blend": (r"deblock_blend_kernel", ("deblock",)),
    "K8 median": (r"median_kernel", ("median_blur",)),
    "K9": (r"cas_kernel", ("cas", "cas_batched")),
}


def _kernel_groups(launches: dict) -> dict:
    """Counter launches summed by the kernel (trace name) they launch."""
    return {g: sum(launches[c] for c in counters) for g, (_, counters) in TRACE_GROUPS.items()}


def _trace_events(prof) -> tuple[list[tuple[float, float, str]], list[float]]:
    """(start, end, name) in us of every device kernel of a profiler run,
    in order of start, and the host duration in us of each
    `cudaGraphLaunch` (its chrome trace, written to a temporary file)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                     if e.get("cat") == "kernel")
    launches = [e["dur"] for e in events if e.get("name") == "cudaGraphLaunch" and "dur" in e]
    return kernels, launches


def _traced_groups(events) -> dict:
    """Kernels of a trace counted by TRACE_GROUPS name."""
    import re

    pats = {g: re.compile(rf"(?<![A-Za-z0-9_]){pat}(?![A-Za-z0-9_])")
            for g, (pat, _) in TRACE_GROUPS.items()}
    return {g: sum(1 for _, _, name in events if pat.search(name)) for g, pat in pats.items()}


def _bit_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0-d count, on the card, of the elements whose bits differ."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return (a != b).sum()


def _reseeded(fresh, like, seed: int = 0):
    """`fresh`'s tensors in the structure of `like`, a compiled step's
    state, its generators reseeded with `seed`: a fresh start that keeps
    the step's graph (a new generator object would make a new one)."""
    import torch.utils._pytree as pytree

    from livevisionkit_tpu_torch.utils import compiled

    state = pytree.tree_unflatten(pytree.tree_leaves(fresh), pytree.tree_structure(like))
    for g in compiled.generators(*pytree.tree_flatten(state)):
        g.manual_seed(seed)
    return state


def run_graph(name, eager_step, graph_step, init, inputs, n, per_step, views) -> dict:
    """A path's compiled step (`graph_step`: `jit_step(step)` or
    `MultiStreamFilter.jit_step()`) against `eager_step` on the same n
    inputs (`inputs(t)`, a tuple), both from `init()` (seed 0), with
    synchronizing calls made errors throughout:

      1. in lockstep: `views(state, out)` (output pixels, valid flags,
         timestamps, the stabilizer's correction offsets) of the graph's
         replay bit-equal to the op-by-op step's, every frame (the mesh
         paths too: the mesh solve sums in a fixed order); the first call
         captures, and its launches (the warm-up's and the capture's) are
         `per_step` x (WARMUP_STEPS + 1), every later graph call none (a
         replay runs no kernel wrapper);
      2. timed: n replays from a fresh state (same graph, generator
         reseeded), device ms (CUDA events) and host ms a frame over the
         last `_timed(n)`, from an idle card, no kernel wrapper called;
      3. traced: GRAPH_TRACE_STEPS replays under torch.profiler (of the
         graph captured while a profiler records, captured first under a
         profiler of its own; after one replay of its warm-up), each
         kernel of `per_step` in the trace `per_step` times a replay (by
         its name), with the launches, busy ms and idle share a step and
         the host time of a `cudaGraphLaunch`.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    per_step = _want(**per_step)
    eager, state = init(), init()
    torch.cuda.synchronize()
    stats, compared = [], 0
    _reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(n):
            args = inputs(t)
            eager, want = eager_step(eager, *args)
            if t == 0:
                _reset_launches()
            state, out = graph_step(state, *args)
            if t == 0:
                capture = _launches()
                _reset_launches()
            pairs = list(zip(views(state, out), views(eager, want)))
            stats.append(torch.stack([_bit_diff(a, b) for a, b in pairs]))
            compared += sum(a.numel() for a, _ in pairs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _launches()
    differ = torch.stack(stats).sum(dim=0).tolist()  # per view
    assert not any(differ), f"{name} graph: elements differing from op by op per view: {differ}"
    want_capture = {k: v * (WARMUP_STEPS + 1) for k, v in per_step.items()}
    assert capture == want_capture, f"{name} graph: launches at capture {capture}, want {want_capture}"
    want_after = {k: v * (n - 1) for k, v in per_step.items()}
    assert after == want_after, (
        f"{name} graph: launches after the capture {after}, want the op-by-op steps' {want_after}")
    del eager, want

    state = _reseeded(init(), state)
    torch.cuda.synchronize()
    timed = _timed(n)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(n):
            if t == n - timed:
                # A replay returns before the card has run it: without this
                # wait the card's backlog would count in the host's window.
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                start.record()
                wall0 = time.perf_counter()
            state, out = graph_step(state, *inputs(t))
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - wall0) * 1e3 / timed
    gpu_ms = start.elapsed_time(end) / timed
    replayed = _launches()
    assert replayed == _want(), f"{name} graph: kernel wrappers called in replays: {replayed}"

    # A step called while a profiler records has a graph of its own, which
    # holds the stage marks (utils/compiled.py: tracing is part of the
    # signature), captured at its first such call after two op-by-op
    # warm-up steps.  That call runs under a profiler of its own, so the
    # traced window below holds replays only.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, out = graph_step(state, *inputs(0))
        torch.cuda.synchronize()

    def trace(state):
        """The kernels and cudaGraphLaunch times of GRAPH_TRACE_STEPS
        replays.  The first replay under the profiler is its warm-up, run
        to its end before the traced window opens."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=GRAPH_TRACE_STEPS,
                                       repeat=1)) as prof:
            for t in range(GRAPH_TRACE_STEPS + 1):
                state, out = graph_step(state, *inputs(t))
                if t in (0, GRAPH_TRACE_STEPS):
                    torch.cuda.synchronize()
                prof.step()
        return state, _trace_events(prof)

    state, (events, launch_us) = trace(state)
    traced = _traced_groups(events)
    want_traced = {g: v * GRAPH_TRACE_STEPS for g, v in _kernel_groups(per_step).items()}
    if traced != want_traced:
        # The profiler can lose kernel records (on the H100 a 4K step's
        # five traced replays once lacked one of their K3 kernels, and
        # other traces of the same replays did not): such a trace holds
        # fewer kernels than another trace of the same replays, which run
        # the same kernels.  A second trace replaces it only then; a graph
        # that lacks a kernel gives two equal traces and fails below.
        state, (again, launch_again) = trace(state)
        if len(again) > len(events):
            print(f"{name} graph: the replays' trace lost {len(again) - len(events)} of "
                  f"{len(again)} kernel records ({traced}); the second trace is checked",
                  flush=True)
            events, launch_us = again, launch_again
            traced = _traced_groups(events)
    assert traced == want_traced, f"{name} graph: kernels in the replays' trace {traced}, want {want_traced}"
    busy = _busy_us([(a, b) for a, b, _ in events])
    span = max(b for _, b, _ in events) - events[0][0]
    rep = {"gpu_ms": gpu_ms, "wall_ms": wall_ms, "capture": capture, "after": after, "traced": traced,
           "kernels_per_step": len(events) / GRAPH_TRACE_STEPS,
           "busy_ms": busy / GRAPH_TRACE_STEPS / 1e3, "idle": 1.0 - busy / span,
           "launch_ms": statistics.mean(launch_us) / 1e3 if launch_us else float("nan")}
    print(f"{name} graph: {n} frames replayed bit-equal to op by op ({compared} elements of "
          f"outputs and corrections), launches at capture {capture}; {gpu_ms:.4f} ms/frame on "
          f"the device, "
          f"{wall_ms:.4f} ms/frame host wall clock (last {timed}); a replay's trace: "
          f"{rep['kernels_per_step']:.1f} kernels, {rep['busy_ms']:.4f} ms busy, "
          f"{100.0 * rep['idle']:.1f}% of the traced span idle, cudaGraphLaunch "
          f"{rep['launch_ms']:.4f} ms on the host, {traced} over {GRAPH_TRACE_STEPS} replays",
          flush=True)
    return rep


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
    b_used, b_over = _paths(lambda c: warp_kernel.warp(img_u8, smap, filter_mode="bilinear",
                                                       block_paths=c), dev)
    assert b_used > 0 and b_over == 0, f"bilinear: {b_over} of {b_used} tiles overflow the box"
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
          f"{n_easu} EASU outputs, {n_src} corner pixels); bilinear: {b_used} tiles stage "
          f"their source box, {b_over} gather from device memory", flush=True)

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
        for mode in ("easu", "bilinear"):
            used, over = _paths(lambda c: warp_kernel.warp(img_u8, omap, filter_mode=mode,
                                                           block_paths=c), dev)
            assert over >= used // 2, (
                f"{name}, {mode}: only {over} of {used} blocks overflow the box")
            err_f = float((warp_kernel.warp(img_f, omap, filter_mode=mode) - remap_ops.remap_plain(
                img_f, omap, filter_mode=mode)).abs().max())
            assert err_f <= 1e-4, f"{name}, {mode}: f32 warp differs from plain by {err_f} > 1e-4"
            max_lsb, frac = _u8_diff(warp_kernel.warp(img_u8, omap, filter_mode=mode),
                                     remap_ops.remap_plain(img_u8, omap, filter_mode=mode))
            assert max_lsb <= 1 and frac <= 1e-3, (
                f"{name}, {mode}: u8 warp max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB "
                f"on 1e-3)")
            ms = _median_ms(lambda: warp_kernel.warp(img_u8, omap, filter_mode=mode))
            print(f"K1 warp {mode}, {name}: {used - over} of {used} blocks stage their source "
                  f"box, {over} gather from device memory; f32 max|err| {err_f:.3e}; u8 max "
                  f"{max_lsb} LSB on {frac:.2e} of pixels; kernel {ms:.4f} ms (u8)", flush=True)
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
    n_bytes = img_u8.numel() * 2 + smaps.numel() * 4
    report["easu"]["bound_ms"], report["easu"]["bound_by"] = _bound(
        n_bytes, _easu_ops(n_easu, n_src, 3))
    n_inside = int((~out).sum())
    report["bilinear"]["bound_ms"], report["bilinear"]["bound_by"] = _bound(
        n_bytes, _bilinear_ops(n_inside, 3))
    print(f"K2 warp_batched easu: bound {report['easu']['bound_ms']:.4f} ms "
          f"({report['easu']['bound_by']}, {n_easu} EASU outputs, {n_src} corner pixels); "
          f"bilinear: bound {report['bilinear']['bound_ms']:.4f} ms "
          f"({report['bilinear']['bound_by']}, {n_inside} outputs inside), "
          f"{100.0 * report['bilinear']['bound_ms'] / report['bilinear']['ms']:.0f}% of it",
          flush=True)

    # Streams under the overflowing maps (each a little apart), each mode.
    kinds = list(OVERFLOW_MAPS.values())
    omaps = torch.stack([_affine_map((H, W), kinds[s % 2][0] * (1.0 + 0.01 * s),
                                     kinds[s % 2][1] + 0.01 * s, dev) for s in range(STREAMS)])
    for mode in ("easu", "bilinear"):
        kw = dict(filter_mode=mode)
        paths = [_paths(lambda c, m=m: warp_kernel.warp(img_u8[0], m, block_paths=c, **kw), dev)
                 for m in omaps]
        assert all(over >= used // 2 for used, over in paths), f"{mode} (used, over): {paths}"
        kf = warp_kernel.warp_batched(img_f, omaps, **kw)
        err_f = float((kf - remap_ops.remap_batched_plain(img_f, omaps, **kw)).abs().max())
        assert err_f <= 1e-4, f"overflowing batched {mode} f32 warp differs by {err_f} > 1e-4"
        assert torch.equal(kf, torch.stack([warp_kernel.warp(img_f[s], omaps[s], **kw)
                                            for s in range(STREAMS)]))
        del kf
        ku = warp_kernel.warp_batched(img_u8, omaps, **kw)
        max_lsb, frac = _u8_diff(ku, remap_ops.remap_batched_plain(img_u8, omaps, **kw))
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"overflowing batched {mode} u8 warp: max {max_lsb} LSB on {frac:.2e} of pixels")
        assert torch.equal(ku, torch.stack([warp_kernel.warp(img_u8[s], omaps[s], **kw)
                                            for s in range(STREAMS)]))
        del ku
        used, over = sum(u for u, _ in paths), sum(o for _, o in paths)
        print(f"K2 warp_batched {mode} under zoom-out / rotation maps: {used - over} of {used} "
              f"blocks stage their source box, {over} gather from device memory; f32 max|err| "
              f"{err_f:.3e}; u8 max {max_lsb} LSB on {frac:.2e} of pixels; bit-equal to "
              f"{STREAMS} solo K1", flush=True)
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


def check_cas(dev, rng) -> dict:
    """K9 against its plain version on the 4K chain's 3x2160x3840 f32
    frame at sharpness 0.8, bit for bit; beside it a `torch.clone` of the
    frame, which moves the same bytes.  No PyTorch call computes CAS
    (library: none)."""
    from livevisionkit_tpu_torch.ops import cas as cas_ops

    img = rcas_input(dev, rng)
    got = cas_ops.cas(img, 0.8)
    want = cas_ops.cas_plain(img, 0.8)
    assert torch.equal(got, want), f"K9 differs from plain by {float((got - want).abs().max())}"
    moved = float((got - img).abs().max())
    del got, want
    assert moved > 1e-3, f"K9 changed no pixel by more than {moved}"
    ms, gap_ms = _median_ms(lambda: cas_ops.cas(img, 0.8)), _median_ms(
        lambda: cas_ops.cas(img, 0.8), spin=False)
    plain_ms = _median_ms(lambda: cas_ops.cas_plain(img, 0.8))
    clone_ms = _median_ms(img.clone)
    bound_ms, bound_by = _bound(4 * 2 * img.numel(), _cas_ops(3, *OUT))
    print(f"K9 cas 3x{OUT[0]}x{OUT[1]}: bit-equal to plain; kernel {ms:.4f} ms ({gap_ms:.4f} "
          f"without the device spin), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of it (f32, sharpness 0.8, median of {RUNS}); library: none; "
          f"floor: torch.clone of the frame {clone_ms:.4f} ms", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "clone_ms": clone_ms}


def check_cas_x8(dev, rng) -> dict:
    """K9's stream axis at the `vs + adb + cas` tick's shape: STREAMS
    3x1080x1920 f32 frames in one launch, bit-equal to STREAMS solo
    launches and to the plain version under vmap, also for one frame
    shared at stream stride 0; beside it a `torch.clone` of the stack."""
    from livevisionkit_tpu_torch.ops import cas as cas_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import cas as k9

    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    base = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)])
    imgs = _stream_stack(base).contiguous()
    peak = cas_ops.cas_peak(0.8)
    got = k9.cas_batched(imgs, peak)
    solo = lambda: [k9.cas(imgs[s], peak) for s in range(STREAMS)]  # noqa: E731
    assert all(torch.equal(got[s], o) for s, o in enumerate(solo())), "K9 x8 is not bit-equal to solo K9"
    shared = k9.cas_batched(imgs[-1][None].expand(STREAMS, -1, -1, -1), peak)
    one = k9.cas(imgs[-1], peak)
    assert all(torch.equal(shared[s], one) for s in range(STREAMS)), "K9 x8 at stride 0 differs"
    del shared, one
    assert torch.equal(got, cas_ops.cas_batched_plain(imgs, 0.8)), "K9 x8 differs from plain"
    del got
    kernel = lambda: k9.cas_batched(imgs, peak)  # noqa: E731
    ms, gap_ms = _median_ms(kernel), _median_ms(kernel, spin=False)
    solo_ms = _median_ms(solo)
    plain_ms = _median_ms(lambda: cas_ops.cas_batched_plain(imgs, 0.8))
    clone_ms = _median_ms(imgs.clone)
    bound_ms, bound_by = _bound(4 * 2 * imgs.numel(), STREAMS * _cas_ops(3, H, W))
    print(f"K9 cas x{STREAMS}: {STREAMS}x3x{H}x{W} in one launch, bit-equal to {STREAMS} solo K9 "
          f"(also at stream stride 0) and to plain; kernel {ms:.4f} ms ({gap_ms:.4f} without the "
          f"device spin), {STREAMS} x solo K9 {solo_ms:.4f} ms, plain (vmap) {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it (f32, median of {RUNS}); "
          f"library: none; floor: torch.clone of the stack {clone_ms:.4f} ms", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "solo_ms": solo_ms, "clone_ms": clone_ms}


RANSAC_N, RANSAC_K, RANSAC_ROUNDS = 510, 256, 4  # the flagship's 17 x 30 grid, hypotheses, IRLS
RANSAC_SIZE = (272, 480)  # the detection frame the features live in


def _ransac_problem(dev, rng, n_streams: int = 1):
    """RANSAC inputs at the flagship's shapes, on the card: RANSAC_N
    correspondences in the detection frame under a near-rigid homography
    with 0.3 px noise, 20% gross outliers, 85% of the features valid, and
    RANSAC_K minimal sets drawn from the valid ones; with `n_streams`, a
    stack of that many problems."""
    out = []
    h_, w_ = RANSAC_SIZE
    for _ in range(n_streams):
        src = rng.uniform([0, 0], [w_, h_], size=(RANSAC_N, 2))
        th, sc = rng.uniform(-0.02, 0.02), 1.0 + rng.uniform(-0.02, 0.02)
        hm = np.array([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(-8, 8)],
                       [sc * np.sin(th), sc * np.cos(th), rng.uniform(-8, 8)],
                       [rng.uniform(-2e-5, 2e-5), rng.uniform(-2e-5, 2e-5), 1.0]])
        ph = np.concatenate([src, np.ones((RANSAC_N, 1))], 1) @ hm.T
        dst = ph[:, :2] / ph[:, 2:3] + rng.normal(0, 0.3, (RANSAC_N, 2))
        bad = rng.uniform(size=RANSAC_N) < 0.2
        dst[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
        valid = rng.uniform(size=RANSAC_N) < 0.85
        idx = np.flatnonzero(valid)[rng.integers(0, int(valid.sum()), size=(RANSAC_K, 4))]
        out.append([torch.from_numpy(src.astype(np.float32)), torch.from_numpy(dst.astype(np.float32)),
                    torch.from_numpy(valid), torch.from_numpy(idx.astype(np.int64))])
    tensors = [torch.stack(t).to(dev) for t in zip(*out)]
    return tensors if n_streams > 1 else [t[0] for t in tensors]


def _ransac_ops(n: int, k: int, rounds: int) -> int:
    """f32 operations of K7 (csrc/ransac.cu) at n points, k hypotheses and
    `rounds` IRLS rounds of the homography, one per add, sub, mul, div,
    sqrt, compare and select: per hypothesis the DLT's Gauss-Jordan (per
    pivot column c: the search, the row swap as selects, the pivot row's
    scaling and the elimination right of the pivot) and ~20 for the
    similarity; per hypothesis and point 28 for the homography's
    truncated-quadratic term and 18 for the similarity's; per round ~165 a
    point (transfer error and weight ~25, the weighted means 10, the mean
    distances 16, the normalised pair and the 29 sums of the normal matrix
    ~115) and ~1,000 for the solve; ~25 a point for the inliers."""
    dlt = sum(2 * (8 - c) + 2 * (7 - c) * (9 - c) + (8 - c) + 14 * (8 - c) for c in range(8))
    return k * (dlt + 20) + k * n * (28 + 18) + rounds * (165 * n + 1000) + 25 * n


def _ransac_bound(n_streams: int = 1) -> tuple[float, str]:
    """K7's least time at the flagship's shapes: its operations, or its
    bytes (each input read once: the point pairs, the valid flags, the
    minimal sets; each output written once)."""
    n, k = RANSAC_N, RANSAC_K
    n_bytes = (16 * n + n + 32 * k + 1) + (36 + n + 4 + 1 + 16)
    return _bound(n_streams * n_bytes, n_streams * _ransac_ops(n, k, RANSAC_ROUNDS))


def _corner_err(m: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest distance (px) between where two (..., 3, 3) models take the
    detection frame's corners, in f64."""
    h_, w_ = RANSAC_SIZE
    c = torch.tensor([[0.0, 0.0, 1.0], [w_ - 1, 0.0, 1.0], [0.0, h_ - 1, 1.0], [w_ - 1, h_ - 1, 1.0]],
                     dtype=torch.float64, device=m.device)
    pa, pb = c @ m.double().transpose(-1, -2), c @ ref.double().transpose(-1, -2)
    return float((pa[..., :2] / pa[..., 2:] - pb[..., :2] / pb[..., 2:]).abs().max())


def check_ransac(dev, rng) -> dict:
    """K7 against its plain version (vision/ransac.estimate_plain) at the
    flagship's shapes (510 features, 256 hypotheses, 4 IRLS rounds), with
    the threshold of each configuration (3 and 10 px) and either model:
    the corner map within 1e-3 px, inliers, `ok`, stability and the
    winners' indices equal, two launches bit-equal.  Then timed, beside the
    plain version and the bound, solo and over STREAMS streams in one
    launch (bit-equal to STREAMS solo launches; the plain version under
    torch.func.vmap)."""
    from livevisionkit_tpu_torch.ops.cuda_kernels import ransac as ransac_kernel
    from livevisionkit_tpu_torch.vision import ransac

    worst = 0.0
    for tau in (3.0, 10.0):
        for use_h in (True, False):
            for _ in range(3):
                src, dst, valid, idx = _ransac_problem(dev, rng)
                uh = torch.tensor(use_h, device=dev)
                args = (src, dst, valid, idx, uh, tau, RANSAC_ROUNDS, 8)
                got = ransac_kernel.ransac_estimate(*args)
                want = ransac.estimate_plain(*args)
                again = ransac_kernel.ransac_estimate(*args)
                err = _corner_err(got[0], want[0])
                assert err <= 1e-3, f"K7 tau {tau} use_h {use_h}: corners {err} px from plain"
                for a, b, name in zip(got[1:], want[1:], ("inliers", "stability", "ok", "winners")):
                    assert torch.equal(a, b), f"K7 tau {tau} use_h {use_h}: {name} differ from plain"
                assert all(torch.equal(_bit_view(a), _bit_view(b)) for a, b in zip(got, again)), (
                    "K7: two launches differ")
                worst = max(worst, err)
    src, dst, valid, idx = _ransac_problem(dev, rng)
    args = (src, dst, valid, idx, torch.tensor(True, device=dev), 3.0, RANSAC_ROUNDS, 8)
    ms = _median_ms(lambda: ransac_kernel.ransac_estimate(*args))
    gap_ms = _median_ms(lambda: ransac_kernel.ransac_estimate(*args), spin=False)
    plain_ms = _median_ms(lambda: ransac.estimate_plain(*args))
    bound_ms, bound_by = _ransac_bound()
    print(f"K7 ransac {RANSAC_N} features x {RANSAC_K} hypotheses, {RANSAC_ROUNDS} rounds: corners "
          f"within {worst:.3e} px of plain over 12 problems (tau 3 and 10, homography and "
          f"similarity), inliers, ok and winners equal, launches bit-equal; kernel {ms:.4f} ms "
          f"({gap_ms:.4f} without the device spin), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} "
          f"ms ({bound_by}: {_ransac_ops(RANSAC_N, RANSAC_K, RANSAC_ROUNDS)} f32 operations) "
          f"(median of {RUNS})", flush=True)
    solo_rep = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    src, dst, valid, idx = _ransac_problem(dev, rng, STREAMS)
    uh = torch.tensor([s % 4 != 3 for s in range(STREAMS)], device=dev)
    bargs = (src, dst, valid, idx, uh, 3.0, RANSAC_ROUNDS, 8)
    got = ransac_kernel.ransac_estimate(*bargs)
    for s in range(STREAMS):
        solo = ransac_kernel.ransac_estimate(src[s], dst[s], valid[s], idx[s], uh[s], 3.0,
                                             RANSAC_ROUNDS, 8)
        assert all(torch.equal(_bit_view(a[s]), _bit_view(b)) for a, b in zip(got, solo)), (
            f"K7 x{STREAMS}: stream {s} differs from its solo launch")
    want = ransac.estimate_batched_plain(*bargs)
    err = _corner_err(got[0], want[0])
    assert err <= 1e-3 and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])), (
        f"K7 x{STREAMS} against plain (vmap): corners {err} px apart, or masks differ")
    ms_b = _median_ms(lambda: ransac_kernel.ransac_estimate(*bargs))
    solo_ms = _median_ms(lambda: [ransac_kernel.ransac_estimate(
        src[s], dst[s], valid[s], idx[s], uh[s], 3.0, RANSAC_ROUNDS, 8) for s in range(STREAMS)])
    plain_b_ms = _median_ms(lambda: ransac.estimate_batched_plain(*bargs))
    bound_b, by_b = _ransac_bound(STREAMS)
    print(f"K7 ransac x{STREAMS}: {STREAMS} streams in one launch, bit-equal to {STREAMS} solo "
          f"launches, corners within {err:.3e} px of plain (vmap); kernel {ms_b:.4f} ms, "
          f"{STREAMS} x solo K7 {solo_ms:.4f} ms, plain (vmap) {plain_b_ms:.4f} ms, bound "
          f"{bound_b:.6f} ms ({by_b}) (median of {RUNS})", flush=True)
    x8_rep = {"max_abs_err": err, "ms": ms_b, "plain_ms": plain_b_ms, "bound_ms": bound_b,
              "bound_by": by_b, "solo_ms": solo_ms}
    return {"solo": solo_rep, "x8": x8_rep}


def check_deblock(dev, rng) -> dict:
    """K8 against its plain versions: the median kernel alone at the 4K
    deblocker's pooled shape (3 x 540 x 960 f32, 5 x 5) bit-equal to
    resample.median_blur_plain, and the deblocker's two kernels at 3 x 2160
    x 3840 f32 (a texture on the 8-bit grid with the blocky staircase, so
    flat blocks smooth fully and textured ones keep) within 1e-6 of
    filters/deblocking.deblock_plain away from the blocks whose 255
    measure is within 1e-4 of an integer 1..L (grown by half a block), two
    launches bit-equal.  Each timed beside its plain version, its bound
    (the median: 12.4 MB moved, or its min/max operations; the pair: the
    frame read twice and written once with the pooled frame and the keep
    map, ~311 MB) and torch.median over the 25 stacked shifted copies, the
    library call the plain median spends its time in."""
    import torch.nn.functional as F

    from livevisionkit_tpu_torch import Frame
    from livevisionkit_tpu_torch.filters import deblocking
    from livevisionkit_tpu_torch.ops import resample
    from livevisionkit_tpu_torch.ops.cuda_kernels import deblock as deblock_kernel
    from livevisionkit_tpu_torch.ops.cuda_kernels.median_net import median_network
    from livevisionkit_tpu_torch.types import PixelFormat

    block, scaling, ksize, levels = BLOCK, 4, 5, 3
    px = rcas_input(dev, rng)
    x0, stair = _staircase(OUT, dev)
    px[0, :, x0:] = stair
    px = torch.round(px.clamp(0.0, 1.0) * 255.0) / 255.0
    small = resample.avg_pool(px, scaling).contiguous()
    n_small = small.numel()

    got = deblock_kernel.median_blur(small, ksize)
    want = resample.median_blur_plain(small, ksize)
    assert torch.equal(_bit_view(got), _bit_view(want)), "K8 median differs from plain"
    r = ksize // 2
    h, w = small.shape[-2:]
    padded = F.pad(small[None], (r, r, r, r), mode="reflect")[0]
    stack = torch.stack([padded[..., dy:dy + h, dx:dx + w] for dy in range(ksize)
                         for dx in range(ksize)])
    med_ops = sum(lo + hi for _, _, lo, hi in median_network(ksize * ksize)) * n_small
    med = {"max_abs_err": 0.0,
           "ms": _median_ms(lambda: deblock_kernel.median_blur(small, ksize)),
           "plain_ms": _median_ms(lambda: resample.median_blur_plain(small, ksize)),
           "library_ms": _median_ms(lambda: torch.median(stack, dim=0))}
    del stack, padded
    med["bound_ms"], med["bound_by"] = _bound(4 * 2 * n_small, med_ops)
    print(f"K8 median_blur 5x5 3x{h}x{w}: bit-equal to plain; kernel {med['ms']:.4f} ms, plain "
          f"{med['plain_ms']:.4f} ms, torch.median over the stack {med['library_ms']:.4f} ms, "
          f"bound {med['bound_ms']:.4f} ms ({med['bound_by']}: {8 * n_small / 1e6:.1f} MB, "
          f"{med_ops / 1e6:.0f} M min/max), share {100 * med['bound_ms'] / med['ms']:.1f}% "
          f"(median of {RUNS})", flush=True)

    yuv = PixelFormat.YUV
    args = (None, block, scaling, ksize, levels)
    got = deblock_kernel.deblock(px, *args)
    again = deblock_kernel.deblock(px, *args)
    want = deblocking.deblock_plain(px, yuv, block, scaling, ksize, levels)
    assert torch.equal(_bit_view(got), _bit_view(again)), "K8 deblock: two launches differ"
    near = _deblock_near(Frame.create(px, fmt=yuv), block, levels)
    away = ~_grown(near, block, block // 2, OUT)
    err = float((got - want).abs()[:, away].max())
    assert err <= 1e-6, f"K8 deblock differs from plain by {err} > 1e-6 away from near blocks"
    moved = float((got - px).abs().max())
    assert moved > 1e-3, f"K8 deblock changed no pixel by more than {moved}"
    del got, again, want
    n = px.numel()
    n_keep = -(-OUT[0] // block) * -(-OUT[1] // block)
    pair_bytes = 4 * (3 * n + 2 * n_small + 2 * n_keep)
    pix_ops = (OUT[0] * OUT[1]) * (3 * 16 + 16)  # per plane the bilinear and blend; keep's upsample
    pair = {"max_abs_err": err, "ms": _median_ms(lambda: deblock_kernel.deblock(px, *args)),
            "gap_ms": _median_ms(lambda: deblock_kernel.deblock(px, *args), spin=False),
            "plain_ms": _median_ms(lambda: deblocking.deblock_plain(px, yuv, block, scaling,
                                                                    ksize, levels)),
            "library_ms": med["library_ms"], "near_blocks": int(near.sum())}
    pair["bound_ms"], pair["bound_by"] = _bound(pair_bytes, med_ops + pix_ops)
    floor_ms = 4 * 2 * n / PEAK_BYTES_S * 1e3
    print(f"K8 deblock (reduce + blend) 3x{OUT[0]}x{OUT[1]}: max|err| {err:.3e} against plain away "
          f"from {pair['near_blocks']} of {near.numel()} near blocks, launches bit-equal; kernels "
          f"{pair['ms']:.4f} ms ({pair['gap_ms']:.4f} without the device spin), plain "
          f"{pair['plain_ms']:.4f} ms, bound {pair['bound_ms']:.4f} ms ({pair['bound_by']}: "
          f"{pair_bytes / 1e6:.1f} MB; the frame in and out once, {floor_ms:.4f} ms), share "
          f"{100 * pair['bound_ms'] / pair['ms']:.1f}% (median of {RUNS})", flush=True)
    return {"median": med, "deblock": pair}


def _bit_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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


def run_solo(name, filt, dev, rng, profile_dir: str | None, graph: bool = True) -> dict:
    """60 1080p frames of a fresh shaky clip through the stabilizer `filt`
    on the card: one warp (K1) and one LK launch (K3) a step, valid flags
    from frame `filt.delay`, finite outputs, tracker ok on >= 90% of frames
    and output jitter below input jitter.  With `graph`, then the step
    compiled (`run_graph`)."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import jit_step

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
    rep = {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms,
           "jitter_in": j_in, "jitter_out": j_out, "state": state, "frames": frames}
    if graph:
        rep["graph"] = run_graph(
            name, filt.step, jit_step(filt.step), lambda: filt.init(spec, device=dev),
            lambda t: (frames[t],), n, {"warp": 1, "lk_track": 1},
            lambda st, out: [out.pixels, out.valid, out.timestamp, st.correction.offsets])
    return rep


def run_slice(dev, rng, profile_dir: str | None, graph: bool = True) -> dict:
    """The flagship stabilizer (homography mode, a 2x2 field)."""
    import livevisionkit_tpu_torch as lvk

    rep = run_solo("slice", lvk.flagship_filter(), dev, rng, profile_dir, graph)
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


def _point_out(offsets: torch.Tensor, x: np.ndarray, size=(H, W)) -> np.ndarray:
    """Where a correction field (normalized (2, hm, wm) offsets, on the
    CPU) puts the (x, y) point x of the delayed frame of `size`: a 2x2
    field by its exact homography, a mesh to first order, x - o(x) * (size
    - 1) with o read bilinearly in the grid (as tools/oracle_pipeline.py
    reads it)."""
    from livevisionkit_tpu_torch.models.warp_field import WarpField

    h, w = size
    if tuple(offsets.shape[-2:]) == (2, 2):
        pt = torch.from_numpy(np.asarray(x, np.float32)[None])
        return WarpField(offsets=offsets).to_homography(size).transform(pt)[0].numpy()
    c = offsets.numpy()
    gh, gw = c.shape[1:]
    fy = float(np.clip(x[1] / (h - 1), 0.0, 1.0)) * (gh - 1)
    fx = float(np.clip(x[0] / (w - 1), 0.0, 1.0)) * (gw - 1)
    y0, x0 = min(int(fy), gh - 2), min(int(fx), gw - 2)
    wy, wx = fy - y0, fx - x0
    v = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x0 + 1] * (1 - wy) * wx
         + c[:, y0 + 1, x0] * wy * (1 - wx) + c[:, y0 + 1, x0 + 1] * wy * wx)
    return np.asarray(x) - np.array([v[1] * (w - 1), v[0] * (h - 1)])


def _jitter(poses, corrections, delay: int, size=(H, W)) -> tuple[float, float]:
    """Jitter of a scene point's path in the input and in the output: input
    x_t = P_t^-1(s); the output at step t shows frame t - delay, corrected
    (`_point_out`).  `poses` are one stream's and `corrections` its (2, hm,
    wm) correction offsets per step, on the CPU; frames are of `size`."""
    from livevisionkit_tpu_torch.models.homography import Homography
    from livevisionkit_tpu_torch.utils import metrics

    h, w = size
    s_pt = torch.tensor([[w / 2 + 160.0, h / 2 + 160.0]])
    x_in, y_out = [], []
    for t in range(delay, len(corrections)):
        x = Homography(m=poses[t - delay].m.cpu()).inverse().transform(s_pt)[0].numpy()
        x_in.append(x)
        y_out.append(_point_out(corrections[t], x, size))
    return metrics.jitter(np.array(x_in)), metrics.jitter(np.array(y_out))


def run_streams(name, filt, dev, poses, clips, n, want, profile_dir: str | None,
                graph: bool = True) -> dict:
    """STREAMS 1080p streams, each its own shaky clip (u8 on the card),
    through `MultiStreamFilter(filt, STREAMS).step` for n ticks with
    synchronizing calls made errors: `want(n)` launches of each kernel
    (one batched launch each a tick), no solo launch, no per-stream
    fallback.  Per stream: valid flags from tick `filt.delay`, finite
    outputs of the filter's output size, tracker ok on >= 90% of ticks and
    output jitter below input jitter.  `filt` is a stabilizer, or a chain
    whose first stage is one.  With `graph`, then `multi.jit_step()`
    (`run_graph`)."""
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
    rep = {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "jitter": jitter}
    if graph:
        del state
        rep["graph"] = run_graph(
            name, multi.step, multi.jit_step(), lambda: multi.init(spec, device=dev),
            lambda t: (frame(t),), n, {k: v // n for k, v in want.items()},
            lambda st, out: [out.pixels, out.valid, out.timestamp, stab(st).correction.offsets])
    return rep


def run_multistream(dev, poses, clips, profile_dir: str | None, graph: bool = True) -> dict:
    """STREAMS flagship streams for N_FRAMES ticks: one batched warp (K2)
    and one LK launch (K3) a tick."""
    import livevisionkit_tpu_torch as lvk

    n = N_FRAMES
    return run_streams("multistream", lvk.flagship_filter(), dev, poses, clips, n,
                       _want(warp_batched=n, lk_track=n), profile_dir, graph)


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
    filter on the card, op by op (`jit=False`) and as one CUDA graph a tick
    (the default); in each, every frame comes out, in order, with no
    stall, op by op one K2 and one K3 launch a tick, the graph's at its
    capture only; timed, then run again in both modes with every output
    digested (BLAKE2b of its bytes, in each stream's writer thread): the
    graph's bit-equal to op by op's."""
    import hashlib

    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.runtime.multistream import stream_multi
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    readers = [_bgr_reader_frames(clips[s, :DRIVER_FRAMES]) for s in range(STREAMS)]
    total = STREAMS * DRIVER_FRAMES
    times = [float(np.float32(t / 30.0)) for t in range(DRIVER_FRAMES)]

    def run(jit: bool, digest: bool) -> dict:
        got = [[] for _ in range(STREAMS)]
        bad = []

        def on_output(i, px, ts):  # each stream's writer thread appends to its own list
            if len(got[i]) % 10 == 0 and not (np.isfinite(px).all() and px.shape == (3, H, W)):
                bad.append((i, ts))
            got[i].append((ts, time.perf_counter(),
                           hashlib.blake2b(px, digest_size=16).digest() if digest else None))

        _reset_launches()
        t0 = time.perf_counter()
        stats = stream_multi(lvk.flagship_filter(), [iter(f) for f in readers], on_output=on_output,
                             device=dev, jit=jit)
        wall = time.perf_counter() - t0
        launches = _launches()
        mode = "graph" if jit else "op by op"
        assert stats.frames_in == total and stats.frames_out == total, (
            f"stream_multi ({mode}): frames in {stats.frames_in}, out {stats.frames_out}, want {total} each")
        assert stats.stalls == 0, f"stream_multi ({mode}): {stats.stalls} stall bubbles"
        per = WARMUP_STEPS + 1 if jit else stats.batches
        want = _want(warp_batched=per, lk_track=per)
        assert launches == want, f"stream_multi ({mode}): kernel launches {launches}, want {want}"
        assert not bad, f"stream_multi ({mode}): bad output frames {bad}"
        for i in range(STREAMS):
            assert [g[0] for g in got[i]] == times, f"stream_multi ({mode}): stream {i} timestamps {got[i]}"
        # A tick's outputs arrive together: stream 0's arrivals time the ticks.
        rep = {"batches": stats.batches, "fps": total / wall,
               "steady_ms": _steady_ms([g[1] for g in got[0]]), "launches": launches,
               "digests": [[g[2] for g in got[i]] for i in range(STREAMS)]}
        mode += ", outputs digested" if digest else ""
        print(f"stream_multi, {mode}: {STREAMS} readers x {DRIVER_FRAMES} u8 BGR 1080p frames, "
              f"{stats.batches} batches, frames in {stats.frames_in} == out {stats.frames_out}, "
              f"{stats.stalls} stalls, per-stream order kept, launches {launches}; "
              f"{rep['fps']:.1f} frames/s aggregate over the whole run ({wall:.3f} s), {rep['steady_ms']:.4f} "
              f"ms/tick host wall clock from tick {STEADY_FROM} on", flush=True)
        return rep

    # Timed without digests (8 writer threads hashing 25 MB outputs would
    # set the pace), then both again with them.
    eager, rep = run(jit=False, digest=False), run(jit=True, digest=False)
    a, b = run(jit=False, digest=True)["digests"], run(jit=True, digest=True)["digests"]
    differ = [(i, t) for i in range(STREAMS) for t, (x, y) in enumerate(zip(a[i], b[i])) if x != y]
    assert not differ, f"stream_multi: graph outputs (stream, frame) {differ} differ from op by op"
    print(f"stream_multi: all {total} graph outputs bit-equal to op by op (BLAKE2b of each "
          f"output's bytes)", flush=True)
    del rep["digests"], eager["digests"]
    rep["eager"] = eager
    return rep


# The serving tools (tools/bench_*_torch.py) at 8 x 1080p.
LOOPBACK_FRAMES = 24  # frames a stream of the loopback
SOAK_FRAMES, SOAK_SECONDS = 30, 20.0  # frames a stream a session; the soak's least length
SCALING_STREAMS = (1, 2, 4, 8)
SCALING_TICKS = 30
LATENCY_FRAMES, LATENCY_WARMUP, LATENCY_FPS = 120, 60, 60.0


def _serving_tools():
    """The tools' modules (tools/ is not a package)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import bench_latency_torch
    import bench_multistream_torch
    import bench_scaling_torch

    return bench_multistream_torch, bench_scaling_torch, bench_latency_torch


def run_serving_tools(dev, clips) -> dict:
    """The serving tools in-process at full width, the flagship filter:

      * the loopback (`bench_multistream_torch.loopback`): STREAMS 1080p
        noise readers, stream 0 slow, stream 1 ending at half the clip, so
        stall bubbles and drain-while-others-live ticks run through the
        tick's graph; it asserts stalls > 0 and the fast streams complete;
      * the soak (`soak`): sessions of STREAMS x SOAK_FRAMES for at least
        SOAK_SECONDS, at least 3, rotating the slow and the early-EOF
        stream; no lost frame, no deadlock, steady pacing, resident and
        reserved memory bounded, one graph a session;
      * end to end (`end_to_end`): STREAMS readers of the clips' N_FRAMES
        u8 BGR frames, aggregate frames/s against 480, and the transfer
        floor;
      * scaling (`bench_scaling_torch.scaling`): the tick graph for S in
        SCALING_STREAMS, efficiency t(1) S / t(S) against 0.8;
      * latency (`bench_latency_torch.latency`): `stream()` fed at
        LATENCY_FPS, the identity pipeline and the flagship, LATENCY_FRAMES
        after LATENCY_WARMUP, with the default in-flight window of 3 (p99
        against 66.7 ms) and with none (each output waited for at once:
        p99 against one frame period, 16.7 ms).

    Each part's rows are printed; a failed gate raises.  Every stream_multi
    session, scaling tick and `stream()` call captures one graph, whose
    warm-up and capture launch each kernel of its step WARMUP_STEPS + 1
    times and whose replays none: the launches of each part are held to
    that count."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    bm, bs, bl = _serving_tools()
    filt, size, per = lvk.flagship_filter(), (H, W), WARMUP_STEPS + 1
    solo, multi = _want(), _want()

    def counted(name, fn, graphs, batched: bool = True):
        """fn()'s result; its launches, `graphs(result)` captures' worth,
        added to the solo or the batched tally."""
        _reset_launches()
        out = fn()
        got, k = _launches(), graphs(out) * per
        want = _want(warp_batched=k, lk_track=k) if batched else _want(warp=k, lk_track=k)
        assert got == want, f"serving {name}: kernel launches {got}, want {want}"
        tally = multi if batched else solo
        for key, v in got.items():
            tally[key] += v
        return out

    def show(name, row):
        print(f"serving {name}: {json.dumps(row)}", flush=True)

    t0 = time.perf_counter()
    # Each stream_multi call captures a graph: the loopback's and the
    # soak's two warm-up runs and their own runs, the end to end's one.
    lb = counted("loopback", lambda: bm.loopback(filt, STREAMS, size, LOOPBACK_FRAMES, dev),
                 lambda r: 3)
    show("loopback", lb)
    sk = counted("soak", lambda: bm.soak(filt, STREAMS, size, SOAK_FRAMES, SOAK_SECONDS, dev),
                 lambda r: 2 + r["sessions"])
    show("soak", sk)
    readers = [_bgr_reader_frames(clips[s]) for s in range(STREAMS)]
    e2e = counted("end to end", lambda: bm.end_to_end(filt, readers, dev), lambda r: 1)
    del readers
    show("end to end", e2e)
    scaling = counted("scaling", lambda: list(bs.scaling(filt, list(SCALING_STREAMS), size, dev,
                                                           SCALING_TICKS)),
                      lambda r: len(r))
    assert [r["streams"] for r in scaling] == list(SCALING_STREAMS), scaling
    for row in scaling:
        assert math.isfinite(row["ms_per_step"]) and row["ms_per_step"] > 0, row
        show(f"scaling S={row['streams']}", row)
    # The flagship's stream() and the graph of its per-frame program, for
    # each window.
    lat = {}
    for inflight in (3, 0):
        lat[inflight] = counted(
            f"latency, in flight {inflight}",
            lambda: bl.latency(filt, size, LATENCY_FRAMES, LATENCY_FPS, LATENCY_WARMUP, inflight, dev),
            lambda r: 2, batched=False)
        for row in lat[inflight]:
            show(f"{row['config']}, in flight {inflight}", row)
    wall = time.perf_counter() - t0
    print(f"serving tools: {wall:.1f} s; launches, solo {solo}, batched {multi}", flush=True)
    return {"loopback": lb, "soak": sk, "e2e": e2e, "scaling": scaling, "latency": lat,
            "solo_launches": solo, "multi_launches": multi, "wall_s": wall}


# The bench and profiling tools (bench_torch.py, tools/bench_matrix_torch.py,
# tools/profile_*_torch.py) and the ladder configs no other phase runs.
LADDER_FRAMES = 20  # frames of a shaky clip through each new ladder config
# The configs of tools/bench_matrix_torch.py that no other phase drives.
NEW_LADDER = ("640x480_gray_stabilization", "1080p_homography_stabilization_bilinear",
              "1080p_mesh_stabilization_bilinear", "4k_homography_stabilization",
              "4k_homography_stabilization_bilinear", "4k_mesh_stabilization",
              "4k_mesh_stabilization_bilinear")
# Each tool's rows, under the JAX tool's names (the text before its colon).
TOOL_ROWS = {
    "profile_stages": ("full step", "tracker.track", "luma+detect resize", "warp.apply 1080p",
                       "smoother", "features.detect"),
    "profile_tracker": ("track (whole)", "pyramid.build", "optical_flow.track", "ransac.estimate",
                        "features.detect"),
    "profile_enhance": ("deblock.avg_pool(1/4)", "deblock.median5@270p", "deblock.up_linear(4x)",
                        "deblock.measure(luma+pools)", "deblock.full-fused",
                        "easu_scale 1080p->4K", "rcas@4K", "easu+rcas fused"),
    "profile_serving_stages": ("full step (easu    )", "full step (bilinear)",
                               f"tracker.track (S={STREAMS})", "queue quant/push/deq "),
    # tools/profile_warp_torch.py's rows: the maps, then for each filter and
    # frame type the whole warps, the kernel, and K2 and S solo launches.
    "profile_warp": ("homography.sample_map 1080p", "warpfield.sample_map 1080p") + tuple(
        name for f in ("easu", "bilinear") for _ in ("u8", "f32")
        for name in ("warp.apply 1080p", "warpfield.apply 1080p", "homography.warp 1080p",
                     "warp kernel 1080p")
        + tuple(f"S={n} {f} {kind}" for n in (1, 2, 4, 8) for kind in ("batched", "lax.map"))),
}
# Kernel launches of each tool's steps, per captured graph (its warm-up
# steps and its capture launch them; a replay calls no wrapper): a sum
# over the graphs of the tool.
TOOL_LAUNCHES = {
    "bench": {"warp": 1, "lk_track": 1},
    # 10 stabilizer configs (the 4K chain's included), the scaler.
    # 1080p_deblock, 4k_deblock and the 4K chain: K8's deblocker.
    # 4k_cas and the 4K chain: K9.
    "bench_matrix": {"warp": 10, "lk_track": 10, "easu_scale": 1, "rcas": 1, "deblock": 3, "cas": 2},
    "profile_stages": {"warp": 2, "lk_track": 2},  # full step, track; warp.apply
    "profile_tracker": {"lk_track": 2},  # track, optical_flow.track (solo or batched)
    # median5@270p and full-fused: resample.median_blur, K8's median.
    "profile_enhance": {"easu_scale": 2, "rcas": 2, "median_blur": 2},
    # The bilinear tick's K2 launch is one of the two.
    "profile_serving_stages": {"warp_batched": 2, "warp_batched_bilinear": 1, "lk_track": 3},
    # For each filter and frame type: warp.apply, warpfield.apply,
    # homography.warp, the kernel alone and sum(S) solo launches (K1); one K2
    # launch for each S.
    "profile_warp": {"warp": 4 * (4 + 15), "warp_batched": 4 * 4, "warp_batched_bilinear": 2 * 4},
}
# Launches outside the graphs: profile_tracker seeds its state with two
# tracks.
TOOL_SEEDING = {"profile_tracker": {"lk_track": 2}}


def _bench_tools():
    """The tools' modules (tools/ is not a package; bench_torch.py sits at
    the root)."""
    root = os.path.dirname(os.path.abspath(__file__))
    for d in (root, os.path.join(root, "tools")):
        if d not in sys.path:
            sys.path.insert(0, d)
    import bench_matrix_torch
    import bench_torch
    import profile_enhance_torch
    import profile_serving_stages_torch
    import profile_stages_torch
    import profile_tracker_torch
    import profile_warp_torch

    return (bench_torch, bench_matrix_torch, profile_stages_torch, profile_tracker_torch,
            profile_enhance_torch, profile_serving_stages_torch, profile_warp_torch)


def run_ladder_config(dev, rng, name, filt, c, size, fmt) -> dict:
    """LADDER_FRAMES frames of a shaky clip of `size` (its Y plane alone for
    GRAY) through the ladder config `filt`: its step compiled (`run_graph`:
    bit-equal to op by op, one K1 and one K3 a step, no host sync), then
    the op-by-op run's outputs held: valid from `filt.delay`, finite, the
    tracker ok on >= 90% of frames, output jitter below input jitter."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import jit_step

    n = LADDER_FRAMES
    poses, pixels = _shaky_render(dev, rng, size, n)
    stamps = torch.arange(n, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)
    frames = [lvk.Frame(pixels=pixels(t)[:c].contiguous(), timestamp=stamps[t], valid=live,
                        format=fmt) for t in range(n)]
    spec = lvk.FrameSpec(*size, c, fmt)
    # First-use work (the resize weights of this size) outside the checks.
    filt.step(filt.init(spec, device=dev), frames[0])
    torch.cuda.synchronize()
    kept = []

    def eager_step(st, fr):
        st, out = filt.step(st, fr)
        kept.append((out.valid, torch.isfinite(out.pixels).all(), st.stability,
                     st.correction.offsets))
        return st, out

    rep = run_graph(name, eager_step, jit_step(filt.step), lambda: filt.init(spec, device=dev),
                    lambda t: (frames[t],), n, {"warp": 1, "lk_track": 1},
                    lambda st, out: [out.pixels, out.valid, out.timestamp, st.correction.offsets])
    valid = [bool(v) for v, _, _, _ in kept]
    assert valid == [t >= filt.delay for t in range(n)], f"{name}: valid flags {valid}"
    assert all(bool(f) for _, f, _, _ in kept), f"{name}: non-finite output pixels"
    ok_frac = sum(float(s) > 0.0 for _, _, s, _ in kept[1:]) / (n - 1)
    assert ok_frac >= 0.9, f"{name}: tracker ok on {ok_frac:.3f} < 0.9 of frames"
    j_in, j_out = _jitter(poses, torch.stack([o for _, _, _, o in kept]).cpu(), filt.delay, size)
    assert j_out < j_in, f"{name}: output jitter {j_out:.3f} px not below input {j_in:.3f} px"
    print(f"{name}: {n} frames of {c}x{size[0]}x{size[1]} {fmt.name}, valid from frame "
          f"{filt.delay}, tracker ok on {ok_frac:.3f} of frames, jitter {j_in:.3f} -> {j_out:.3f} "
          f"px", flush=True)
    rep["launches"] = {k: rep["capture"][k] + rep["after"][k] for k in rep["capture"]}
    rep.update(jitter_in=j_in, jitter_out=j_out, ok_frac=ok_frac)
    return rep


def check_warp_ladder(dev, rng) -> dict:
    """K1 at the shapes the new ladder configs give it, on u8 frames as the
    stabilizer's delay queue holds them, against its plain version (f32
    within 1e-4, u8 within 1 LSB on at most 1e-3 of pixels) under
    check_warp's stabilization-scale similarity scaled to the frame: EASU
    at C = 1 (GRAY) 480x640 and at 3x2160x3840, bilinear at 3x1080x1920 and
    3x2160x3840.  No PyTorch call computes EASU or samples a u8 frame
    (F.grid_sample takes floats): library_ms is null."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    cases = {"warp_gray": (1, (480, 640), "easu", lvk.PixelFormat.GRAY),
             "warp_4k": (3, OUT, "easu", lvk.PixelFormat.YUV),
             "warp_bilinear_u8": (3, (H, W), "bilinear", lvk.PixelFormat.YUV),
             "warp_bilinear_u8_4k": (3, OUT, "bilinear", lvk.PixelFormat.YUV)}
    report = {}
    for name, (c, (h, w), mode, fmt) in cases.items():
        luma = torch.from_numpy(_texture(h, w, rng)).to(dev)
        img_f = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)])[:c]
        img_f = img_f.contiguous()
        img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
        k = h / H
        smap = _similarity(1.01, math.radians(0.5), 12.0 * k, -7.0 * k, dev).sample_map((h, w))
        smap = smap.contiguous()
        err_f = float((warp_kernel.warp(img_f, smap, filter_mode=mode, fmt=fmt)
                       - remap_ops.remap_plain(img_f, smap, filter_mode=mode, fmt=fmt)).abs().max())
        assert err_f <= 1e-4, f"{name}: f32 warp differs from plain by {err_f} > 1e-4"
        kernel = lambda: warp_kernel.warp(img_u8, smap, filter_mode=mode, fmt=fmt)  # noqa: E731
        plain = lambda: remap_ops.remap_plain(img_u8, smap, filter_mode=mode, fmt=fmt)  # noqa: E731
        max_lsb, frac = _u8_diff(kernel(), plain())
        assert max_lsb <= 1 and frac <= 1e-3, (
            f"{name}: u8 warp max {max_lsb} LSB on {frac:.2e} of pixels (bound 1 LSB on 1e-3)")
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        n_bytes = img_u8.numel() * 2 + smap.numel() * 4
        if mode == "easu":
            n_out, n_src = _easu_work(smap, h, w)
            bound, side = _bound(n_bytes, _easu_ops(n_out, n_src, c))
        else:
            inside = (smap[0] >= 0) & (smap[0] <= h - 1) & (smap[1] >= 0) & (smap[1] <= w - 1)
            bound, side = _bound(n_bytes, _bilinear_ops(int(inside.sum()), c))
        print(f"K1 {name} ({mode}, u8 {c}x{h}x{w} {fmt.name}): f32 max|err| {err_f:.3e}; u8 max "
              f"{max_lsb} LSB on {frac:.2e} of pixels; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({side}), {100.0 * bound / ms:.0f}% of it (median of {RUNS})",
              flush=True)
        report[name] = {"max_abs_err": max_lsb, "f32_err": err_f, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": side}
    return report


def run_bench_tools(dev) -> dict:
    """The bench and profiling tools' phase, on a generator of its own:

      1. the seven ladder configs no other phase runs (NEW_LADDER: 640x480
         GRAY; the bilinear stabilizers at 1080p; the homography and mesh
         stabilizers at 4K, EASU and bilinear), each over LADDER_FRAMES
         frames of a shaky clip (`run_ladder_config`), then K1 at their
         shapes against plain (`check_warp_ladder`);
      2. the six tools in-process at full width, their defaults (60
         replays, 3 runs a row): bench_torch, the 14 configs of
         bench_matrix_torch, profile_stages, profile_tracker at S = 1 and
         S = STREAMS and with the mesh preset's tracker at S = 1,
         profile_enhance, profile_serving_stages at S = STREAMS and
         profile_warp (EASU and bilinear, u8 and f32, K2 at S = 1, 2, 4,
         8 against S solo launches, and the warp.apply split into map
         build, kernel and the rest).  Every row is finite and above an
         empty kernel's time, every row name is there, and each tool's
         launches are TOOL_LAUNCHES' x (WARMUP_STEPS + 1) (the captures;
         replays launch through no wrapper) and TOOL_SEEDING's.

    Between configs and rows every graph and its pool is released."""
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    bt, bm, ps, pt, pe, pss, pw = _bench_tools()
    ladder = {}
    for name, filt, c, h, w, fmt in bm.configs():
        if name in NEW_LADDER:
            ladder[name] = run_ladder_config(dev, rng, name, filt, c, (h, w), fmt)
            torch.cuda.empty_cache()
    assert tuple(ladder) == NEW_LADDER, tuple(ladder)
    k1 = check_warp_ladder(dev, rng)
    t_ladder = time.perf_counter() - t0

    floor = empty_kernel_ms()
    per = WARMUP_STEPS + 1
    launches = {}

    def counted(tool, fn):
        _reset_launches()
        out = fn()
        seeding = TOOL_SEEDING.get(tool, {})
        got = _launches()
        want = _want(**{k: v * per + seeding.get(k, 0) for k, v in TOOL_LAUNCHES[tool].items()})
        assert got == want, f"{tool}: kernel launches {got}, want {want}"
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out

    size = (H, W)
    line = counted("bench", lambda: bt.bench(size, dev))
    rows = {"bench": [(line["metric"], line["value"])]}
    rows["bench_matrix"] = [(r["config"], r["value"]) for r in counted(
        "bench_matrix", lambda: list(bm.matrix(None, dev)))]
    rows["profile_stages"] = counted("profile_stages", lambda: ps.stages(size, dev))
    for s_, mesh in ((1, False), (STREAMS, False), (1, True)):
        key = f"profile_tracker S={s_}" + (" mesh" if mesh else "")
        rows[key] = counted("profile_tracker", lambda: pt.tracker(s_, size, dev, mesh))
    rows["profile_enhance"] = counted("profile_enhance", lambda: pe.enhance(size, dev))
    rows["profile_serving_stages"] = counted(
        "profile_serving_stages", lambda: pss.serving_stages(STREAMS, size, dev))
    warp_rows = counted("profile_warp", lambda: pw.profile(size, dev))
    rows["profile_warp"] = [(f"{r['row']} ({r['filter']}, {r['dtype']})", r["ms"])
                            for r in warp_rows]
    warp_split = pw.split(warp_rows)

    want = {"bench": ("1080p_stabilization_latency",),
            "bench_matrix": tuple(c[0] for c in bm.configs()),
            "profile_stages": TOOL_ROWS["profile_stages"],
            "profile_tracker S=1": TOOL_ROWS["profile_tracker"],
            f"profile_tracker S={STREAMS}": TOOL_ROWS["profile_tracker"],
            "profile_tracker S=1 mesh": TOOL_ROWS["profile_tracker"] + ("mesh_motion.estimate",),
            "profile_enhance": TOOL_ROWS["profile_enhance"],
            "profile_serving_stages": TOOL_ROWS["profile_serving_stages"],
            "profile_warp": TOOL_ROWS["profile_warp"]}
    assert len(want["bench_matrix"]) == 14
    for key, names in want.items():
        got = [n for n, _ in rows[key]] if key != "profile_warp" else [r["row"] for r in warp_rows]
        assert tuple(got) == names, f"{key}: rows {got}"
        bad = [(n, ms) for n, ms in rows[key] if not (math.isfinite(ms) and ms > floor)]
        assert not bad, f"{key}: rows not finite or under the {floor:.4f} ms launch floor: {bad}"
    wall = time.perf_counter() - t0
    print(f"bench tools: {wall:.1f} s ({t_ladder:.1f} s of it the new ladder configs and K1); "
          f"launches {launches}; floor {floor:.4f} ms", flush=True)
    print(f"{_gpu_line()} | bench tools, ms: "
          + " | ".join(f"{key}: " + ", ".join(f"{n.strip()} {ms:.4f}" for n, ms in r)
                       for key, r in rows.items())
          + " | new ladder configs as graphs (device / host): "
          + ", ".join(f"{n} {r['gpu_ms']:.4f} / {r['wall_ms']:.4f}" for n, r in ladder.items()),
          flush=True)
    print(f"{_gpu_line()} | profile_warp, warp.apply 1080p split (ms): " + " | ".join(
        f"{f} {d}: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        for (f, d), parts in warp_split.items()), flush=True)
    return {"ladder": ladder, "k1": k1, "rows": rows, "launches": launches,
            "warp_split": warp_split, "floor_ms": floor, "wall_s": wall}


def run_chain(dev, rng, profile_dir: str | None) -> dict:
    """60 1080p frames through the flagship stabilizer and the FSR scaler
    to 4K at sharpness 0.8 (the CLI's `vs,fsr.size=3840x2160` chain), the
    chain compiled (`run_graph`), then the scaler alone on the same
    frames."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import jit_step

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
    del state
    graph = run_graph("chain", chain.step, jit_step(chain.step), lambda: chain.init(spec, device=dev),
                      lambda t: (frames[t],), n,
                      {"warp": 1, "lk_track": 1, "easu_scale": 1, "rcas": 1},
                      lambda st, out: [out.pixels, out.valid, out.timestamp, st[0].correction.offsets])

    _reset_launches()
    _, sc_gpu_ms, sc_wall_ms = _drive(scaler, (), frames, lambda t, st, out: None)
    sc_launches = _launches()
    assert sc_launches == _want(easu_scale=n, rcas=n), sc_launches
    print(f"scaler alone: 1080p -> 4K EASU + RCAS 0.8, {sc_gpu_ms:.4f} ms/frame on the device, "
          f"{sc_wall_ms:.4f} ms/frame host wall clock (last {N_TIMED} of {n} frames)", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "graph": graph,
            "scaler_gpu_ms": sc_gpu_ms, "scaler_wall_ms": sc_wall_ms, "scaler_launches": sc_launches}


# ------------------------------------------------------------------------
# The enhancement filters: deblocker, CAS, alpha planes and debug overlays.

UHD = OUT  # the 4K full chain's frames: 2160 x 3840 YUV
ADB_CAS_TICKS = 30  # ticks of the 8-stream vs + adb + cas phase
DEBUG_STEPS = 15  # steps of the debug-overlay phases (outputs from step 10)
BLOCK = 16  # the deblocker's macroblock
STEP_LSB = 2  # the blocky region's steps, in 8-bit levels


def _staircase(size, dev) -> tuple[int, torch.Tensor]:
    """The blocky region of a frame: from column x0 (two thirds across, on a
    16-pixel boundary) to the right edge, a horizontal staircase of 16-wide
    steps STEP_LSB levels apart on the u8 grid, as block-coded video decodes
    a smooth gradient.  Its blocks are flat (keep 0), the textured rest is
    not (keep 1).  Returns x0 and the (w - x0,) row."""
    h, w = size
    x0 = (2 * w // 3) // BLOCK * BLOCK
    steps = torch.div(torch.arange(w - x0, device=dev), BLOCK, rounding_mode="floor")
    return x0, (51.0 + STEP_LSB * steps.to(torch.float32)) / 255.0


def _blocky_frame(pixels: torch.Tensor, x0: int, stair: torch.Tensor) -> torch.Tensor:
    """u8 YUV frame: the rendered (3, h, w) pixels with the staircase over
    the luma right of x0, quantized."""
    px = pixels.clone()
    px[0, :, x0:] = stair
    return torch.clamp(px * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def _blockiness(px: torch.Tensor, x0: int) -> torch.Tensor:
    """The blocky region's step height (0-d, on the device): the mean over
    its rows of the row's largest horizontal luma difference, 64 pixels in
    from the region's and the frame's edges (the stabilizer moves the region
    by its correction).  2/255 on the input staircase; a smoothed step is
    spread over several pixels and lower."""
    h, w = px.shape[-2:]
    y = px[0, 64:h - 64, x0 + 64:w - 64]
    return (y[:, 1:] - y[:, :-1]).abs().amax(dim=1).mean()


def run_full_chain(dev, rng, profile_dir: str | None) -> dict:
    """N_FRAMES frames of a shaky 2160x3840 YUV clip with a blocky region
    (u8 on the card) through the JAX package's `4k_full_chain_fused`
    (tools/bench_matrix.py:141-156): the mesh stabilizer
    (`stabilization_preset(model="field")`), the deblocker and CAS in one
    CompositeFilter.  One K1 (on the mesh's dense 4K map) and one K3
    launch a step, valid flags from the delay, finite
    outputs in [0, 1], the tracker ok on >= 90% of frames, output jitter
    below input jitter, and the blocky region's steps below 0.7x the input's
    (`_blockiness`).  The deblocker's keep map of the first frame is
    neither all 0 nor all 1.  Then the chain compiled (`run_graph`), and K1
    on the eager drive's last dense map at 4K against plain, with its
    device-memory tiles."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import jit_step
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
    from livevisionkit_tpu_torch.presets import stabilization_preset

    h, w = UHD
    poses, pixels = _shaky_render(dev, rng, UHD)
    x0, stair = _staircase(UHD, dev)
    clip = torch.empty((N_FRAMES, 3, h, w), dtype=torch.uint8, device=dev)
    for t in range(N_FRAMES):
        clip[t] = _blocky_frame(pixels(t), x0, stair)
    fmt = lvk.PixelFormat.YUV
    # Timestamps and the valid flag are on the card before the drive: a
    # Python number made a device tensor inside it is a synchronizing copy.
    stamps = torch.arange(N_FRAMES, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)

    def frame(t):
        return lvk.Frame(pixels=clip[t].to(torch.float32) * (1.0 / 255.0), timestamp=stamps[t],
                         valid=live, format=fmt)

    influence = lvk.DeblockingFilter().influence_map(frame(0))[::BLOCK, ::BLOCK]
    smoothed = float((influence > 0.5).float().mean())
    assert 0.05 <= smoothed <= 0.95, f"keep map smooths {smoothed:.3f} of the blocks"
    blocky_in = float(torch.stack([_blockiness(clip[t].to(torch.float32) / 255.0, x0)
                                   for t in range(N_FRAMES)]).mean())

    filt = lvk.CompositeFilter((lvk.StabilizationFilter(settings=stabilization_preset(model="field")),
                                lvk.DeblockingFilter(), lvk.CASFilter()))
    n, delay = N_FRAMES, filt.delay
    spec = lvk.FrameSpec(h, w, 3, fmt)
    filt.step(filt.init(spec, device=dev), frame(0))  # fills the per-shape caches
    state = filt.init(spec, device=dev)
    torch.cuda.synchronize()
    valids, finite, lo, hi, corrections, stabilities, blocky = [], [], [], [], [], [], []

    def keep(t, st, out):
        assert out.pixels.shape == (3, h, w)
        valids.append(out.valid)
        finite.append(torch.isfinite(out.pixels).all())
        lo.append(out.pixels.amin())
        hi.append(out.pixels.amax())
        corrections.append(st[0].correction.offsets)
        stabilities.append(st[0].stability)
        blocky.append(_blockiness(out.pixels, x0))

    _reset_launches()
    state, gpu_ms, wall_ms = _drive(filt, state, (frame(t) for t in range(n)), keep, n=n)
    launches = _launches()
    assert launches == _want(warp=n, lk_track=n, deblock=n, cas=n), (
        f"full chain: kernel launches {launches}")
    valid = [bool(v) for v in valids]
    assert valid == [t >= delay for t in range(n)], f"full chain: valid flags {valid}"
    assert all(bool(f) for f in finite), "full chain: non-finite output pixels"
    lo_all, hi_all = min(float(v) for v in lo), max(float(v) for v in hi)
    assert -1e-5 <= lo_all and hi_all <= 1.0 + 1e-5, f"full chain: outputs span [{lo_all}, {hi_all}]"
    ok = [float(v) > 0.0 for v in stabilities[1:]]
    ok_frac = sum(ok) / len(ok)
    assert ok_frac >= 0.9, f"full chain: tracker ok on {ok_frac:.3f} < 0.9 of frames"
    j_in, j_out = _jitter(poses, torch.stack(corrections).cpu(), delay, UHD)
    assert j_out < j_in, f"full chain: output jitter {j_out:.3f} px not below input {j_in:.3f} px"
    blocky_out = float(torch.stack(blocky[delay:]).mean())
    assert blocky_out < 0.7 * blocky_in, (
        f"full chain: blocky region's steps {blocky_out * 255:.3f} / 255, input {blocky_in * 255:.3f}")
    print(f"full_chain: {n} frames {h}x{w} -> mesh stabilizer + deblock + CAS, valid from frame "
          f"{delay}, tracker ok on {ok_frac:.3f} of frames, jitter {j_in:.3f} -> {j_out:.3f} px, "
          f"outputs in [{lo_all:.6f}, {hi_all:.6f}], keep map smooths {smoothed:.3f} of the first "
          f"frame's blocks, blocky region's steps {blocky_in * 255:.3f} -> {blocky_out * 255:.3f} "
          f"/ 255, launches {launches}", flush=True)
    print(f"full_chain: {gpu_ms:.4f} ms/frame on the device (CUDA events over the last "
          f"{_timed(n)} frames), {wall_ms:.4f} ms/frame host wall clock; budget 16.6 ms "
          f"(4K60)", flush=True)
    if profile_dir:
        _profile(filt.step, state, [frame(t) for t in range(5)], os.path.join(profile_dir, "full_chain"))
    smap = state[0].correction.sample_map(UHD).contiguous()
    del state
    graph = run_graph("full_chain", filt.step, jit_step(filt.step), lambda: filt.init(spec, device=dev),
                      lambda t: (frame(t),), n, {"warp": 1, "lk_track": 1, "deblock": 1, "cas": 1},
                      lambda st, out: [out.pixels, out.valid, out.timestamp, st[0].correction.offsets])

    img_u8 = clip[-1].contiguous()
    used, over = _paths(lambda c: warp_kernel.warp(img_u8, smap, block_paths=c), dev)
    img_f = img_u8.to(torch.float32) / 255.0
    err_f = float((warp_kernel.warp(img_f, smap) - remap_ops.remap_plain(
        img_f, smap, filter_mode="easu")).abs().max())
    assert err_f <= 1e-4, f"4K dense map: f32 warp differs from plain by {err_f} > 1e-4"
    max_lsb, frac = _u8_diff(warp_kernel.warp(img_u8, smap),
                             remap_ops.remap_plain(img_u8, smap, filter_mode="easu"))
    assert max_lsb <= 1 and frac <= 1e-3, f"4K dense map: u8 warp max {max_lsb} LSB on {frac:.2e}"
    k1_ms = _median_ms(lambda: warp_kernel.warp(img_u8, smap))
    print(f"K1 warp easu on the full chain's dense 4K map: {over} of {used} blocks gather from "
          f"device memory; f32 max|err| {err_f:.3e}; u8 max {max_lsb} LSB on {frac:.2e} of pixels; "
          f"kernel {k1_ms:.4f} ms (u8 3x{h}x{w})", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "jitter": (j_in, j_out),
            "blockiness": (blocky_in, blocky_out), "k1_used": used, "k1_over": over, "k1_ms": k1_ms,
            "frame0": frame(0), "x0": x0, "graph": graph}


def _kernel_launches(fn, calls: int = 3) -> tuple[float, float]:
    """(kernel launches, device busy ms) per call of fn, from a
    torch.profiler trace of `calls` calls (written under build/ and
    removed)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    kernels = _traced_kernels(prof, path)
    os.remove(path)
    return len(kernels) / calls, _busy_us(kernels) / 1e3 / calls


def _deblock_near(frame, block: int, levels: int) -> torch.Tensor:
    """(blocks) bool: the deblocker's blocks, over the edge-padded frame,
    whose 255 measure (on the frame's device) lies within 1e-4 of an
    integer 1..levels, where the floor may go either way."""
    import torch.nn.functional as F

    from livevisionkit_tpu_torch.filters import deblocking
    from livevisionkit_tpu_torch.ops import color

    _, h, w = frame.pixels.shape
    ph, pw = -(-h // block) * block, -(-w // block) * block
    px = F.pad(frame.pixels[None], (0, pw - w, 0, ph - h), mode="replicate")[0]
    m = deblocking.block_measure(color.luma(px, frame.format), block) * 255.0
    k = torch.round(m)
    return ((m - k).abs() < 1e-4) & (k >= 1) & (k <= levels)


def _grown(near: torch.Tensor, block: int, r: int, size) -> torch.Tensor:
    """(h, w) bool: the pixels within r of a near block."""
    px = near.repeat_interleave(block, 0).repeat_interleave(block, 1)[None, None].float()
    grown = torch.nn.functional.max_pool2d(px, 2 * r + 1, stride=1, padding=r)[0, 0] > 0
    return grown[:size[0], :size[1]]


def check_filters_alone(dev, rng, frame_4k) -> dict:
    """The deblocker at 1080p (1080 % 16 = 8: the edge pad and the partial
    border) and at 4K, and CAS at 4K, each alone on a blocky YUV frame:
    ms/frame (CUDA events behind the device spin), kernel launches and busy
    ms per frame (profiler), and the byte bound (the frame read once and
    written once, f32, over 3.35 TB/s).  Each against the same op on a CPU
    copy of its input: CAS within 1e-6; the deblocker's per-block keep
    equal on every block whose 255 measure is not within 1e-4 of an integer
    1..L, its influence map within 1e-6 and its output within 1e-5 away
    from them (half a block, the keep upsample's reach)."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.filters import deblocking
    from livevisionkit_tpu_torch.ops import color

    _, pixels = _shaky_render(dev, rng)
    x0, stair = _staircase((H, W), dev)
    frame_hd = lvk.Frame.create(_blocky_frame(pixels(0), x0, stair).to(torch.float32) / 255.0,
                                fmt=lvk.PixelFormat.YUV)
    deblock, cas = lvk.DeblockingFilter(), lvk.CASFilter()
    s = deblock.settings
    report = {}
    for name, filt, frame in (("deblock_1080p", deblock, frame_hd), ("deblock_4k", deblock, frame_4k),
                              ("cas_4k", cas, frame_4k)):
        _, out = filt.step((), frame)
        cpu_frame = lvk.Frame.create(frame.pixels.cpu(), fmt=frame.format)
        _, want = filt.step((), cpu_frame)
        got = out.pixels.cpu()
        size = tuple(frame.pixels.shape[-2:])
        if filt is cas:
            err = float((got - want.pixels).abs().max())
            assert err <= 1e-6, f"{name}: differs from the CPU by {err} > 1e-6"
            extra = ""
        else:
            near = _deblock_near(cpu_frame, s.block_size, s.detection_levels)
            away = ~_grown(near, s.block_size, s.block_size // 2, size)
            err = float((got - want.pixels).abs()[:, away].max())
            assert err <= 1e-5, f"{name}: differs from the CPU by {err} > 1e-5 away from near blocks"
            fh, fw = size[0] // s.block_size * s.block_size, size[1] // s.block_size * s.block_size
            keep = [deblocking.keep_blocks(deblocking.block_measure(
                color.luma(f.pixels[:, :fh, :fw], f.format), s.block_size), s.detection_levels).cpu()
                for f in (frame, cpu_frame)]
            near_c = _deblock_near(lvk.Frame.create(cpu_frame.pixels[:, :fh, :fw], fmt=frame.format),
                                   s.block_size, s.detection_levels)
            assert torch.equal(keep[0][~near_c], keep[1][~near_c]), f"{name}: keep blocks differ"
            inf_err = float((deblock.influence_map(frame).cpu() - deblock.influence_map(cpu_frame))
                            .abs()[:fh, :fw][~_grown(near_c, s.block_size, s.block_size // 2, (fh, fw))]
                            .max())
            assert inf_err <= 1e-6, f"{name}: influence map differs from the CPU by {inf_err}"
            smoothed = float((keep[1] < 1.0).float().mean())
            extra = (f"; {int(near.sum())} of {near.numel()} blocks near an integer 255 measure "
                     f"(excluded); influence map max|err| {inf_err:.3e}; {smoothed:.3f} of the "
                     f"blocks blend in the smooth frame")
        step = lambda f=filt, fr=frame: f.step((), fr)  # noqa: E731
        ms = _median_ms(step)
        launches, busy_ms = _kernel_launches(step)
        bound_ms, bound_by = _bound(2 * 4 * frame.pixels.numel(), 0)
        print(f"{name}: 3x{size[0]}x{size[1]} f32, max|err| against the CPU {err:.3e}{extra}; "
              f"{ms:.4f} ms/frame (CUDA events, median of {RUNS}), {launches:.0f} kernel launches, "
              f"{busy_ms:.4f} ms device busy a frame, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        report[name] = {"err": err, "ms": ms, "launches": launches, "busy_ms": busy_ms,
                        "bound_ms": bound_ms}
    return report


def _c4_frame(dev, rng) -> torch.Tensor:
    """A (4, 1080, 1920) u8 YUV + alpha frame: a texture's luma, chroma
    planes, and another texture as alpha."""
    luma = torch.from_numpy(_texture(H, W, rng)).to(dev)
    alpha = torch.from_numpy(_texture(H, W, rng)).to(dev)
    img_f = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1), alpha])
    return torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8).contiguous()


def check_warp_c4(dev, rng) -> tuple[dict, dict]:
    """K1 and K2 at four planes, the stabilizer's colour + alpha gather: a
    1080p YUV + alpha frame on the flagship's stabilization map and on a
    16x16 mesh's dense map, u8 and f32, against the plain version (f32
    within 1e-4, u8 at most 1 LSB on at most 0.1% of pixels), its colour
    planes against the 3-plane launch (EASU's luma is plane 0, never
    alpha); K2 over STREAMS such frames bit-equal to STREAMS solo K1
    launches and against plain.  Times and bounds."""
    from livevisionkit_tpu_torch.models.warp_field import WarpField
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    img_u8 = _c4_frame(dev, rng)
    img_f = img_u8.to(torch.float32) / 255.0
    offsets = torch.from_numpy(rng.uniform(-0.003, 0.003, size=(2, 16, 16)).astype(np.float32)).to(dev)
    maps = {"flagship": _similarity(1.01, math.radians(0.5), 12.0, -7.0, dev).sample_map((H, W)),
            "mesh": WarpField(offsets=offsets).sample_map((H, W))}
    k1 = {}
    for name, smap in maps.items():
        smap = smap.contiguous()
        err_f = float((warp_kernel.warp(img_f, smap) - remap_ops.remap_plain(
            img_f, smap, filter_mode="easu")).abs().max())
        assert err_f <= 1e-4, f"K1 C=4 on the {name} map: f32 differs from plain by {err_f}"
        got = warp_kernel.warp(img_u8, smap)
        max_lsb, frac = _u8_diff(got, remap_ops.remap_plain(img_u8, smap, filter_mode="easu"))
        assert max_lsb <= 1 and frac <= 1e-3, f"K1 C=4 on the {name} map: u8 max {max_lsb} on {frac:.2e}"
        colour = warp_kernel.warp(img_u8[:3].contiguous(), smap)
        c_lsb, c_frac = _u8_diff(got[:3], colour)
        assert c_lsb <= 1 and c_frac <= 1e-3, f"K1 C=4 colour planes differ from C=3 by {c_lsb} LSB"
        used, over = _paths(lambda c, m=smap: warp_kernel.warp(img_u8, m, block_paths=c), dev)
        ms = _median_ms(lambda m=smap: warp_kernel.warp(img_u8, m))
        plain_ms = _median_ms(lambda m=smap: remap_ops.remap_plain(img_u8, m, filter_mode="easu"), runs=5)
        n_easu, n_src = _easu_work(smap, H, W)
        bound_ms, bound_by = _bound(img_u8.numel() * 2 + smap.numel() * 4, _easu_ops(n_easu, n_src, 4))
        print(f"K1 warp easu C=4 (YUV + alpha u8 4x{H}x{W}) on the {name} map: f32 max|err| "
              f"{err_f:.3e}; u8 max {max_lsb} LSB on {frac:.2e} of pixels; colour planes within "
              f"{c_lsb} LSB of the C=3 launch on {c_frac:.2e}; {over} of {used} blocks gather from "
              f"device memory; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 5), bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        k1[name] = {"max_abs_err": max_lsb, "f32_err": err_f, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}

    imgs = _stream_stack(img_u8).contiguous()
    sims = [(1.0 + 0.004 * s, math.radians(0.25 * (s - 3)), 6.0 * s - 20.0, 9.0 - 3.0 * s)
            for s in range(STREAMS)]
    smaps = torch.stack([_similarity(*p, dev).sample_map((H, W)) for p in sims]).contiguous()
    got = warp_kernel.warp_batched(imgs, smaps)
    solo = lambda: [warp_kernel.warp(imgs[s], smaps[s]) for s in range(STREAMS)]  # noqa: E731
    assert all(torch.equal(got[s], o) for s, o in enumerate(solo())), "K2 C=4 is not bit-equal to solo K1"
    max_lsb, frac = _u8_diff(got, remap_ops.remap_batched_plain(imgs, smaps, filter_mode="easu"))
    assert max_lsb <= 1 and frac <= 1e-3, f"K2 C=4: u8 max {max_lsb} LSB on {frac:.2e}"
    ms = _median_ms(lambda: warp_kernel.warp_batched(imgs, smaps))
    solo_ms = _median_ms(solo)
    plain_ms = _median_ms(lambda: remap_ops.remap_batched_plain(imgs, smaps, filter_mode="easu"), runs=3)
    n_easu, n_src = _easu_work(smaps, H, W)
    bound_ms, bound_by = _bound(imgs.numel() * 2 + smaps.numel() * 4, _easu_ops(n_easu, n_src, 4))
    print(f"K2 warp_batched easu C=4: {STREAMS}x4x{H}x{W} u8 in one launch, bit-equal to {STREAMS} "
          f"solo K1; u8 max {max_lsb} LSB on {frac:.2e} of pixels; kernel {ms:.4f} ms, {STREAMS} x "
          f"solo K1 {solo_ms:.4f} ms, plain (vmap) {plain_ms:.4f} ms (median of 3), bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    k2 = {"max_abs_err": max_lsb, "ms": ms, "plain_ms": plain_ms, "solo_ms": solo_ms,
          "bound_ms": bound_ms, "bound_by": bound_by}
    return k1, k2


def run_adb_cas_multistream(dev, poses, clips, profile_dir: str | None) -> dict:
    """STREAMS flagship streams through the JAX package's multi-chip dry
    run chain `vs + adb + cas` (__graft_entry__.py:94-128) for ADB_CAS_TICKS
    ticks: one K2, one K3, one K8 deblock call (the STREAMS streams'
    deblockers in its two launches) and one K9 launch a tick."""
    import livevisionkit_tpu_torch as lvk

    n = ADB_CAS_TICKS
    chain = lvk.CompositeFilter((lvk.flagship_filter(), lvk.DeblockingFilter(), lvk.CASFilter()))
    return run_streams("adb_cas_multistream", chain, dev, poses, clips, n,
                       _want(warp_batched=n, lk_track=n, deblock=n, cas_batched=n), profile_dir)


class _Lockstep:
    """Two filters stepped on the same frames, each on its own state."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def step(self, state, frame):
        sa, oa = self.a.step(state[0], frame)
        sb, ob = self.b.step(state[1], frame)
        return (sa, sb), (oa, ob)


def _overlay_mask(px: torch.Tensor, fmt) -> torch.Tensor:
    """(h, w) bool: the pixels holding a stabilizer overlay's colour."""
    from livevisionkit_tpu_torch.ops import drawing

    mask = torch.zeros(px.shape[-2:], dtype=torch.bool, device=px.device)
    for name in ("green", "magenta", "yellow"):
        col = drawing.colour(name, fmt)
        mask |= torch.stack([px[c] == col[c] for c in range(len(col))]).all(0)
    return mask


def run_debug(dev, rng, clips) -> dict:
    """The stabilizer's test mode with alpha planes at 1080p, with
    synchronizing calls made errors: `flagship_filter()` with debug=True
    beside the plain one from the same seed on YUV + alpha frames for
    DEBUG_STEPS steps (one K1 a step each, at four planes): pixels differ
    only where an overlay is drawn, and there hold its colour, and both
    carry the same warped alpha; then the debug filter over STREAMS streams
    with alpha (one K2 at four planes a tick)."""
    import dataclasses

    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter

    fmt = lvk.PixelFormat.YUV
    plain = lvk.flagship_filter()
    debug = dataclasses.replace(plain, debug=True)
    _, pixels = _shaky_render(dev, rng)
    frames = []
    for t in range(DEBUG_STEPS):
        px = pixels(t)
        frames.append(lvk.Frame.create(px, timestamp=t / 30.0, fmt=fmt, alpha=px[0].flip(1).contiguous()))
    spec = lvk.FrameSpec(H, W, 3, fmt, has_alpha=True)
    pair = _Lockstep(debug, plain)
    pair.step((debug.init(spec, device=dev), plain.init(spec, device=dev)), frames[0])
    state = (debug.init(spec, device=dev), plain.init(spec, device=dev))
    torch.cuda.synchronize()
    valids, outside, changed, drawn, alpha_diff = [], [], [], [], []

    def keep(t, st, out):
        od, op = out
        valids.append(od.valid & op.valid)
        overlay = _overlay_mask(od.pixels, fmt)
        diff = (od.pixels - op.pixels).abs().amax(0)
        outside.append(((diff > 0) & ~overlay).sum())
        changed.append((diff > 0).sum())
        drawn.append(overlay.sum())
        alpha_diff.append((od.alpha - op.alpha).abs().max())

    _reset_launches()
    _, gpu_ms, wall_ms = _drive(pair, state, frames, keep)
    solo_launches = _launches()
    n = DEBUG_STEPS
    assert solo_launches == _want(warp=2 * n, lk_track=2 * n), f"debug: launches {solo_launches}"
    live = [t for t, v in enumerate(valids) if bool(v)]
    assert live == list(range(plain.delay, n)), f"debug: valid steps {live}"
    bad = sum(int(outside[t]) for t in live)
    assert bad == 0, f"debug: {bad} pixels off the overlays differ from the plain filter"
    assert all(int(changed[t]) > 0 and int(drawn[t]) > 0 for t in live), "debug: no overlay drawn"
    a_err = max(float(alpha_diff[t]) for t in live)
    assert a_err == 0.0, f"debug: alpha differs from the plain filter's by {a_err}"
    print(f"debug: {n} steps of the flagship filter with debug=True beside the plain one, 1080p "
          f"YUV + alpha; overlays on {min(int(drawn[t]) for t in live)}-"
          f"{max(int(drawn[t]) for t in live)} pixels a frame, 0 pixels off them differ, alpha "
          f"equal; launches {solo_launches} (K1 at 4 planes); {gpu_ms:.4f} / {wall_ms:.4f} ms a "
          f"step pair (device / host)", flush=True)

    multi = MultiStreamFilter(debug, STREAMS)
    live_s = torch.ones(STREAMS, dtype=torch.bool, device=dev)

    def frame(t):
        px = clips[:, t].to(torch.float32) * (1.0 / 255.0)
        return lvk.Frame(pixels=px, timestamp=torch.full((STREAMS,), t / 30.0, device=dev), valid=live_s,
                         alpha=px[:, 0].flip(-1).contiguous(), format=fmt)

    multi.step(multi.init(spec, device=dev), frame(0))
    mstate = multi.init(spec, device=dev)
    torch.cuda.synchronize()
    mvalid, mdrawn, alpha_lo, alpha_hi = [], [], [], []

    def mkeep(t, st, out):
        assert out.alpha.shape == (STREAMS, H, W)
        mvalid.append(out.valid)
        mdrawn.append(torch.stack([_overlay_mask(out.pixels[s], fmt).sum() for s in range(STREAMS)]))
        alpha_lo.append(out.alpha.amin())
        alpha_hi.append(out.alpha.amax())

    _reset_launches()
    _, tick_gpu_ms, tick_wall_ms = _drive(multi, mstate, (frame(t) for t in range(n)), mkeep, n=n)
    multi_launches = _launches()
    assert multi_launches == _want(warp_batched=n, lk_track=n), f"debug x{STREAMS}: {multi_launches}"
    v = torch.stack(mvalid).cpu()
    assert (v[plain.delay:].all() and not v[:plain.delay].any()), f"debug x{STREAMS}: valid {v}"
    assert bool((torch.stack(mdrawn)[plain.delay:] > 0).all()), f"debug x{STREAMS}: overlays missing"
    lo, hi = float(torch.stack(alpha_lo).min()), float(torch.stack(alpha_hi).max())
    assert 0.0 <= lo and hi <= 1.0, f"debug x{STREAMS}: alpha spans [{lo}, {hi}]"
    print(f"debug x{STREAMS}: {n} ticks of {STREAMS} 1080p YUV + alpha streams with debug=True, "
          f"overlays on every stream's valid frames, alpha in [{lo:.4f}, {hi:.4f}], launches "
          f"{multi_launches} (K2 at 4 planes); {tick_gpu_ms:.4f} / {tick_wall_ms:.4f} ms a tick "
          f"(device / host)", flush=True)
    return {"solo_launches": solo_launches, "multi_launches": multi_launches, "gpu_ms": gpu_ms,
            "wall_ms": wall_ms, "tick_gpu_ms": tick_gpu_ms, "tick_wall_ms": tick_wall_ms}


# ---------------------------------------------------------------------------
# The runtime slice: the `lvk-torch` chain through `stream()`, its profile,
# HUD and trace, lens correction alone, `process_clip`, ingest, snapshots
# and calibration, all at 1080p.  The script needs no OpenCV, so the
# drives read in-memory lists of host u8 BGR frames.
# ---------------------------------------------------------------------------

LVK_SPECS = ("lc.profile=camera", "vs.crop_out=1", "adb")  # the CLI's -f specs
HUD_FRAMES = 20  # frames of the HUD run (10 outputs after the delay)
TRACE_FRAMES = 10  # frames of the DeviceTrace run
LC_STEPS = 20  # lens-correction steps per mode and plane count
# The lc profile and the calibration phase's camera: 1080p, barrel k1.
CAMERA = {"fx": 1450.0, "fy": 1430.0, "cx": 967.0, "cy": 533.0, "k1": -0.2}
BOARD = (9, 6)  # inner corners of the calibration chessboard
BOARD_VIEWS = 12
# One 8-bit level of chroma through YUV -> BGR, whose largest chroma gain is
# 2.03 (U into B): the clip's chroma is 0.5 only up to the rounding of its
# u8 BGR frames and of the stabilizer's u8 delay queue (0.5 is stored as
# 128 / 255), and filtering plane by plane puts a pixel's luma beside its
# neighbours' chroma, so BGR leaves [0, 1] by a fraction of that.
RANGE_EPS = 2.04 / 255.0


def _bgr_reader_frames(clip: torch.Tensor) -> list:
    """A (T, 3, H, W) u8 YUV clip on the card as host (u8 HWC BGR,
    timestamp) pairs: the in-memory reader of `stream()`."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import color

    frames = []
    for t in range(clip.shape[0]):
        x = color.convert(clip[t].to(torch.float32) * (1.0 / 255.0), lvk.PixelFormat.YUV,
                          lvk.PixelFormat.BGR)
        u8 = torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).permute(1, 2, 0)
        frames.append((u8.contiguous().cpu().numpy(), t / 30.0))
    return frames


def _lvk_chain(tmp: str):
    """The chain `lvk-torch -f lc.profile=camera -f vs.crop_out=1 -f adb`,
    built by the CLI's own spec parser and filter registry: lens correction
    from CAMERA (written to `tmp/camera`: the spec grammar splits options
    on '.', so the profile is named relative to `tmp`), the flagship
    stabilizer cropped to its stable region, and the deblocker."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.runtime import cli

    with open(os.path.join(tmp, "camera"), "w") as fh:
        json.dump(lvk.CameraParameters(**CAMERA).to_dict(), fh)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        filters = tuple(cli._build_filter(*cli._parse_filter_spec(s)) for s in LVK_SPECS)
    finally:
        os.chdir(cwd)
    return lvk.CompositeFilter(filters=filters)


def _timestamps(n: int) -> list[float]:
    """The driver's timestamps of frames 0..n-1 (float32 seconds)."""
    return [float(np.float32(t / 30.0)) for t in range(n)]


STEADY_FROM = 20  # outputs before the steady-state window of a driver run


def _steady_ms(arrivals: list[float]) -> float:
    """Host ms per output between the STEADY_FROM-th output's arrival and
    the last one's (past the capture and the pipeline's fill)."""
    return (arrivals[-1] - arrivals[STEADY_FROM]) * 1e3 / (len(arrivals) - 1 - STEADY_FROM)


def run_lvk_stream(dev, frames, tmp) -> dict:
    """The `lvk-torch` chain (lc + vs + adb) through `stream()` over 60
    in-memory 1080p BGR frames, with synchronizing calls made errors around
    each whole run (the drain's event waits are the only waits): op by op
    (`jit=False`) and as one CUDA graph a frame (the default), timed, then
    both again with a digest of every output.  In each: frames in == 60,
    out == 60 - delay, output timestamps those of frames 0..59-delay,
    outputs finite and in [0, 1] within RANGE_EPS; op by op two K1
    launches (lc and vs) and one K3 a frame, the graph's at its capture
    only; every graph output bit-equal to op by op's (a BLAKE2b digest of
    its bytes, taken in the writer thread of the last two runs).
    Then the chain's step alone compiled (`run_graph`).  A short run first
    fills the per-shape caches."""
    import hashlib

    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.runtime.pipeline import ingest
    from livevisionkit_tpu_torch.runtime.stream import stream
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS, jit_step

    filt = _lvk_chain(tmp)
    n, delay = len(frames), filt.delay
    stream(filt, iter(frames[:delay + 2]), device=dev, jit=False)
    torch.cuda.synchronize()

    def run(jit: bool, digest: bool) -> dict:
        got = []

        def on_output(px, ts):  # the writer thread: the checks a real encoder's place takes
            got.append((ts, px.shape, float(px.min()), float(px.max()), time.perf_counter(),
                        hashlib.blake2b(px, digest_size=16).digest() if digest else None))

        _reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            stats = stream(filt, iter(frames), on_output=on_output, device=dev, jit=jit)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
        launches = _launches()
        mode = "graph" if jit else "op by op"
        assert stats.frames_in == n, f"lvk stream ({mode}): frames in {stats.frames_in}, want {n}"
        assert stats.frames_out == n - delay == len(got), (
            f"lvk stream ({mode}): frames out {stats.frames_out} ({len(got)} written), want {n - delay}")
        assert [g[0] for g in got] == _timestamps(n - delay), (
            f"lvk stream ({mode}): timestamps {[g[0] for g in got]}")
        bad = [t for t, (_, shape, lo, hi, _, _) in enumerate(got)
               if shape != (3, H, W) or not (-RANGE_EPS <= lo and hi <= 1.0 + RANGE_EPS)]
        assert not bad, f"lvk stream ({mode}): outputs {bad} not finite (3, {H}, {W}) in [0, 1] +- {RANGE_EPS}"
        per = WARMUP_STEPS + 1 if jit else n
        want = _want(warp=2 * per, lk_track=per, deblock=per)
        assert launches == want, f"lvk stream ({mode}): launches {launches}, want {want}"
        ft, q = stats.frame_time, stats.latency_quantiles()
        rep = {"launches": launches, "fps": stats.frames_out / wall, "fps_stopwatch": stats.fps,
               "frame_ms": ft.average_ms(), "frame_dev_ms": ft.deviation_ms(),
               "steady_ms": _steady_ms([g[4] for g in got]), "digests": [g[5] for g in got],
               "lo": min(g[2] for g in got), "hi": max(g[3] for g in got), "wall": wall, **q}
        mode += ", outputs digested" if digest else ""
        print(f"lvk stream ({' '.join('-f ' + s for s in LVK_SPECS)}), {mode}: {n} 1080p BGR "
              f"frames in, {stats.frames_out} out (delay {delay}), timestamps in order, outputs "
              f"in [{rep['lo']:.5f}, {rep['hi']:.5f}], no sync in the run; launches {launches}; "
              f"{rep['fps']:.2f} frames/s over the run ({wall:.3f} s), {stats.fps:.2f} by the "
              f"frame stopwatch; {rep['steady_ms']:.4f} ms/frame host wall clock from output "
              f"{STEADY_FROM} on; frame time {ft.average_ms():.4f} ms +- {ft.deviation_ms():.4f} "
              f"ms; latency p50 {q['p50_ms']:.4f} / p95 {q['p95_ms']:.4f} / p99 "
              f"{q['p99_ms']:.4f} ms", flush=True)
        return rep

    # Timed without digests, then both again with them.
    eager, rep = run(jit=False, digest=False), run(jit=True, digest=False)
    a, b = run(jit=False, digest=True)["digests"], run(jit=True, digest=True)["digests"]
    differ = [t for t, (x, y) in enumerate(zip(a, b)) if x != y]
    assert not differ, f"lvk stream: graph outputs {differ} differ from op by op"
    print(f"lvk stream: all {len(b)} graph outputs bit-equal to op by op (BLAKE2b of each "
          f"output's bytes)", flush=True)

    fmt = lvk.PixelFormat.YUV
    clip = [torch.from_numpy(f).to(dev) for f, _ in frames]
    stamps = torch.arange(n, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)

    def frame(t):
        return lvk.Frame(pixels=ingest(clip[t]), timestamp=stamps[t], valid=live,
                         format=lvk.PixelFormat.BGR).reformat(fmt)

    spec = lvk.FrameSpec(H, W, 3, fmt)
    rep["graph"] = run_graph("lvk_chain", filt.step, jit_step(filt.step),
                             lambda: filt.init(spec, device=dev), lambda t: (frame(t),), n,
                             {"warp": 2, "lk_track": 1, "deblock": 1},
                             lambda st, out: [out.pixels, out.valid, out.timestamp,
                                              st[1].correction.offsets])
    rep["eager"] = {k: v for k, v in eager.items() if k != "digests"}
    del rep["digests"]
    return rep


def _hud_stamped(px: np.ndarray) -> bool:
    """Does the (3, H, W) output carry the frame-time HUD's glyphs (at least
    20 pixels of its green or red) at its origin?"""
    from livevisionkit_tpu_torch.runtime.hud import GREEN, RED

    region = px[:, 6:21, 6:200]
    return any(int((region == np.asarray(c, np.float32).reshape(3, 1, 1)).all(0).sum()) >= 20
               for c in (GREEN, RED))


def run_lvk_profile(dev, frames, tmp) -> dict:
    """The same chain with profile_filters=True (each filter stepped alone
    and waited for): per-filter ms under the JAX driver's "i:name" keys;
    then HUD_FRAMES frames with the 6 ms HUD, stamped on every output."""
    from livevisionkit_tpu_torch.runtime.stream import stream

    filt = _lvk_chain(tmp)
    stats = stream(filt, iter(frames), device=dev, profile_filters=True)
    keys = ["0:LensCorrectionFilter", "1:StabilizationFilter", "2:DeblockingFilter"]
    assert list(stats.filter_times) == keys, f"profile keys {list(stats.filter_times)}"
    times = {k: (w.average_ms(), w.deviation_ms(), w.count) for k, w in stats.filter_times.items()}
    assert all(c == len(frames) for _, _, c in times.values()), f"profile counts {times}"
    print("lvk stream --profile-filters: " + "; ".join(
        f"{k} {a:.4f} ms +- {d:.4f} (n={c})" for k, (a, d, c) in times.items()) +
        f"; frame time {stats.frame_time.average_ms():.4f} ms", flush=True)

    stamped = []
    hud = stream(filt, iter(frames[:HUD_FRAMES]), on_output=lambda px, ts: stamped.append(_hud_stamped(px)),
                 hud_budget_ms=6.0, device=dev)
    assert hud.frames_out == HUD_FRAMES - filt.delay == len(stamped), f"HUD run: {hud.frames_out} out"
    assert all(stamped), f"HUD missing on outputs {[t for t, s in enumerate(stamped) if not s]}"
    print(f"lvk stream --hud 6.0: {len(stamped)} outputs, the HUD on every one", flush=True)
    return {"filter_ms": {k: a for k, (a, _, _) in times.items()}}


def run_lvk_trace(dev, frames, tmp) -> dict:
    """TRACE_FRAMES frames of the chain inside `DeviceTrace` (the graph
    captured inside the trace, as the CLI's `--trace` does it): the Chrome
    trace holds a `frame` span a frame, the runtime's read_wait / upload /
    replay / download spans (utils/profiling.py's names) and the card's
    kernels, K1 twice and K3 and K7 once a frame (the replays) and a
    warm-up step."""
    from livevisionkit_tpu_torch.runtime.stream import stream
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS
    from livevisionkit_tpu_torch.utils.profiling import DeviceTrace

    filt = _lvk_chain(tmp)
    with DeviceTrace(os.path.join(tmp, "trace"), device=dev) as tr:
        stream(filt, iter(frames[:TRACE_FRAMES]), device=dev)
    with open(tr.path) as fh:
        events = json.load(fh)["traceEvents"]
    size_mb = os.path.getsize(tr.path) / 2**20
    os.remove(tr.path)
    names = {e.get("name") for e in events}
    want = {"frame", "read_wait", "upload", "replay", "download"}
    assert want <= names, f"trace lacks {sorted(want - names)}"
    # A span `frame` a frame (and one for the read that found the end).
    frame_spans = sum(1 for e in events if e.get("name") == "frame"
                      and e.get("cat") == "user_annotation")
    assert frame_spans >= TRACE_FRAMES, f"trace holds {frame_spans} frame spans"
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    assert kernels > 0, "trace holds no device kernel"
    traced = _traced_groups([(0.0, 0.0, e.get("name", "")) for e in events if e.get("cat") == "kernel"])
    steps = TRACE_FRAMES + WARMUP_STEPS
    want = {"K1/K2": 2 * steps, "K3/K4": steps, "K5": 0, "K6": 0, "K7": steps,
            "K8 reduce": steps, "K8 blend": steps, "K8 median": 0, "K9": 0}
    assert traced == want, f"DeviceTrace: kernels {traced}, want {want}"
    print(f"DeviceTrace: {TRACE_FRAMES} frames, {len(events)} events ({size_mb:.1f} MiB), "
          f"{kernels} kernels ({traced}: replays and the warm-up step), {frame_spans} frame "
          f"spans, the read_wait/upload/replay/download spans present", flush=True)
    return {"kernels": kernels, "traced": traced}


def _bilinear_ops(n_out: int, nc: int) -> int:
    """f32 operations of n_out bilinear outputs of nc channels in the plain
    version (ops/remap.bilinear_sample): per output two floors, two
    fractions, four clamped indices (8) and the inside test with its
    selects (5), and per channel three lerps of 3 operations each."""
    return n_out * (2 + 2 + 8 + 5 + 9 * nc)


def check_lens_correction(dev, clip) -> dict:
    """`LensCorrectionFilter` alone at 1080p, on the undistort map of CAMERA
    (a 33x33 field, alpha 0: cropped to the valid region), in EASU and in
    bilinear mode: K1 on its dense map against the plain version at C = 3
    and C = 4 (colour + alpha), f32 within 1e-4 and u8 within 1 LSB on at
    most 1e-3 of pixels (check_warp's bounds), and its time beside plain,
    the bound and, for bilinear, F.grid_sample on the same map; then
    LC_STEPS steps of the filter on f32 YUV frames with and without alpha,
    with synchronizing calls made errors, one K1 launch a step."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel

    fmt = lvk.PixelFormat.YUV
    stamps = torch.arange(LC_STEPS, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)
    pix = [clip[t].to(torch.float32) * (1.0 / 255.0) for t in range(LC_STEPS)]
    plain_frames = [lvk.Frame(pixels=p, timestamp=stamps[t], valid=live, format=fmt)
                    for t, p in enumerate(pix)]
    alpha_frames = [f.replace(alpha=f.pixels[0].flip(1).contiguous()) for f in plain_frames]
    img_f = pix[0]
    img_c4 = torch.cat([img_f, alpha_frames[0].alpha[None]]).contiguous()
    report = {}
    for mode in ("easu", "bilinear"):
        filt = lvk.LensCorrectionFilter(parameters=lvk.CameraParameters(**CAMERA), warp_filter=mode)
        field = filt.init(lvk.FrameSpec(H, W, 3, fmt), device=dev)
        smap = field.sample_map((H, W)).contiguous()
        errs = {}
        for name, img in (("f32", img_f), ("f32 C=4", img_c4)):
            d = (warp_kernel.warp(img, smap, fill=0.0, filter_mode=mode)
                 - remap_ops.remap_plain(img, smap, fill=0.0, filter_mode=mode)).abs()
            errs[name] = float(d.max())
            assert errs[name] <= 1e-4, f"lc {mode} {name}: K1 differs from plain by {errs[name]}"
        for name, img in (("u8", img_f), ("u8 C=4", img_c4)):
            u8 = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
            errs[name] = _u8_diff(warp_kernel.warp(u8, smap, fill=0.0, filter_mode=mode),
                                  remap_ops.remap_plain(u8, smap, fill=0.0, filter_mode=mode))
            assert errs[name][0] <= 1 and errs[name][1] <= 1e-3, f"lc {mode} {name}: {errs[name]}"
        ms = _median_ms(lambda: warp_kernel.warp(img_f, smap, fill=0.0, filter_mode=mode))
        ms_c4 = _median_ms(lambda: warp_kernel.warp(img_c4, smap, fill=0.0, filter_mode=mode))
        plain_ms = _median_ms(lambda: remap_ops.remap_plain(img_f, smap, fill=0.0, filter_mode=mode))
        inside = (smap[0] >= 0) & (smap[0] <= H - 1) & (smap[1] >= 0) & (smap[1] <= W - 1)
        n_bytes = img_f.numel() * 4 * 2 + smap.numel() * 4
        if mode == "easu":
            n_easu, n_src = _easu_work(smap, H, W)
            bound, side = _bound(n_bytes, _easu_ops(n_easu, n_src, 3))
        else:
            bound, side = _bound(n_bytes, _bilinear_ops(int(inside.sum()), 3))
        rep = {"max_abs_err": errs["f32"], "ms": ms, "ms_c4": ms_c4, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": side, "library_ms": None, "errs": errs}
        if mode == "bilinear":
            # grid_sample clamps where the kernel fills: compared inside the frame.
            grid = torch.stack([smap[1] * (2.0 / (W - 1)) - 1.0, smap[0] * (2.0 / (H - 1)) - 1.0],
                               dim=-1)[None].contiguous()
            gs = lambda: torch.nn.functional.grid_sample(  # noqa: E731
                img_f[None], grid, mode="bilinear", padding_mode="border", align_corners=True)
            rep["library_err"] = float(((gs()[0] - remap_ops.remap_plain(
                img_f, smap, fill=0.0, filter_mode="bilinear")).abs() * inside).max())
            rep["library_ms"] = _median_ms(gs)
        launches = {}
        for name, frames in (("C=3", plain_frames), ("C=4", alpha_frames)):
            spec = lvk.FrameSpec.of(frames[0])
            state = filt.init(spec, device=dev)
            filt.step(state, frames[0])
            outs = []
            _reset_launches()
            _, gpu_ms, wall_ms = _drive(filt, state, frames, lambda t, st, out: outs.append(out))
            launches[name] = _launches()
            assert launches[name] == _want(warp=LC_STEPS), f"lc {mode} {name}: {launches[name]}"
            assert all(o.pixels.shape == (3, H, W) and (o.alpha is not None) == (name == "C=4")
                       for o in outs)
            rep[f"step_{name}"] = (gpu_ms, wall_ms)
        rep["launches"] = {k: sum(v[k] for v in launches.values()) for k in launches["C=3"]}
        lib = (f", F.grid_sample {rep['library_ms']:.4f} ms (max |grid_sample - plain| inside "
               f"{rep['library_err']:.3e})") if mode == "bilinear" else ""
        print(f"lc {mode} on the undistort map: K1 f32 max|err| {errs['f32']:.3e} (C=4 "
              f"{errs['f32 C=4']:.3e}); u8 max {errs['u8'][0]} LSB on {errs['u8'][1]:.2e} of pixels "
              f"(C=4 {errs['u8 C=4'][0]} on {errs['u8 C=4'][1]:.2e}); kernel f32 3x{H}x{W} {ms:.4f} "
              f"ms, 4 planes {ms_c4:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({side})"
              f"{lib}; the filter's step {rep['step_C=3'][0]:.4f} / {rep['step_C=3'][1]:.4f} ms, "
              f"with alpha {rep['step_C=4'][0]:.4f} / {rep['step_C=4'][1]:.4f} ms (device / host), "
              f"one K1 a step", flush=True)
        report[mode] = rep
    return report


PROCESS_CLIP_TRACED = 10  # frames of the traced process_clip run
CLIP_REPEATS = 3  # timed process_clip calls of each length


def run_process_clip(dev, clip) -> dict:
    """`process_clip` of the flagship filter over the 60-frame YUV clip held
    on the card (as f32 planes), with synchronizing calls made errors: one
    CUDA graph replayed a frame, its launches counted at its capture only
    (the warm-up's and the capture's), every output bit-equal to stepping
    the same filter frame by frame, op by op, from the same seed (the frame
    loop timed too); then `process_clip` of the first PROCESS_CLIP_TRACED
    frames under torch.profiler: K1 and K3 once a replay and once in the
    warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.runtime.offline import process_clip
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    filt, fmt = lvk.flagship_filter(), lvk.PixelFormat.YUV
    n = clip.shape[0]
    pixels = clip.to(torch.float32) / 255.0  # (60, 3, 1080, 1920) f32, 1.5 GB
    torch.cuda.synchronize()

    def timed(fn):
        """fn(), its device and host ms in all."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            start.record()
            out = fn()
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    # Each call captures its graph; the difference of an n-frame and an
    # n/2-frame call is n/2 replays (the JAX bench's scan-length
    # differencing), each call's time the least of CLIP_REPEATS, taken in
    # turns.
    half, whole = [], []
    for _ in range(CLIP_REPEATS):
        half.append(timed(lambda: process_clip(filt, pixels[:n // 2], fmt, device=dev))[1:])
        _reset_launches()
        (_, out), gpu_all, wall_all = timed(lambda: process_clip(filt, pixels, fmt, device=dev))
        whole.append((gpu_all, wall_all))
    launches = _launches()
    per = WARMUP_STEPS + 1
    assert launches == _want(warp=per, lk_track=per), f"process_clip: launches {launches}"
    (gpu_all, wall_all), (gpu_half, wall_half) = ([min(c) for c in zip(*runs)] for runs in (whole, half))
    gpu_ms, wall_ms = ((gpu_all - gpu_half) / (n - n // 2), (wall_all - wall_half) / (n - n // 2))
    stamps = torch.arange(n, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)

    def loop():
        state = filt.init(lvk.FrameSpec(H, W, 3, fmt), device=dev, seed=0)
        differ = []
        for t in range(n):
            state, ref = filt.step(state, lvk.Frame(pixels=pixels[t], timestamp=stamps[t],
                                                    valid=live, format=fmt))
            differ.append(_bit_diff(out.pixels[t], ref.pixels) + _bit_diff(out.valid[t], ref.valid)
                          + _bit_diff(out.timestamp[t], ref.timestamp))
        return torch.stack(differ)

    _reset_launches()
    differ, e_gpu, e_wall = timed(loop)
    e_gpu, e_wall = e_gpu / n, e_wall / n
    e_launches = _launches()
    assert e_launches == _want(warp=n, lk_track=n), f"process_clip frame loop: launches {e_launches}"
    bad = [t for t, d in enumerate(differ.tolist()) if d]
    assert not bad, f"process_clip differs from the frame loop at frames {bad}"
    valid = out.valid.tolist()
    assert valid == [t >= filt.delay for t in range(n)], f"process_clip: valid {valid}"
    del out

    k = PROCESS_CLIP_TRACED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        process_clip(filt, pixels[:k], fmt, device=dev)
        torch.cuda.synchronize()
    traced = _traced_groups(_trace_events(prof)[0])
    want = {"K1/K2": k + WARMUP_STEPS, "K3/K4": k + WARMUP_STEPS, "K5": 0, "K6": 0,
            "K7": k + WARMUP_STEPS, "K8 reduce": 0, "K8 blend": 0, "K8 median": 0, "K9": 0}
    assert traced == want, f"process_clip trace: kernels {traced}, want {want}"
    print(f"process_clip: {n} 1080p frames of the flagship filter, one graph replayed a frame, "
          f"bit-equal to the op-by-op frame loop, launches at the capture {launches} (the loop's "
          f"{e_launches}), {traced} in the trace of {k} frames; {gpu_ms:.4f} ms/frame device, "
          f"{wall_ms:.4f} ms/frame host ({n}-frame call less {n // 2}-frame call, each the "
          f"least of {CLIP_REPEATS}; the whole {n}-frame call {gpu_all:.1f} / {wall_all:.1f} ms, "
          f"its capture included); frame loop {e_gpu:.4f} / {e_wall:.4f} ms/frame", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "eager_gpu_ms": e_gpu,
            "eager_wall_ms": e_wall, "traced": traced, "call_ms": (gpu_all, wall_all)}


def check_ingest_codecs(dev, rng) -> dict:
    """The OBS codecs at 1080p on the card against the same codec on the
    CPU (plain host tensors): uploads of I420, NV12, YUY2, UYVY and BGRA
    within 1 LSB (luma exactly y / 255), and their downloads within 1 LSB;
    the native host library builds and loads, and its YUY2 / UYVY unpack equals
    the numpy slices."""
    from livevisionkit_tpu_torch.runtime import ingest, native_host

    assert native_host.get_lib() is not None, "native host library did not build or load"
    hh, hw = H // 2, W // 2
    y = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    gy, gx = np.mgrid[0:H, 0:hw]
    u422 = (128 + 60 * np.sin(gx / 23.0) + rng.integers(-6, 7, size=(H, hw))).clip(0, 255).astype(np.uint8)
    v422 = (128 + 60 * np.cos(gy / 17.0) + rng.integers(-6, 7, size=(H, hw))).clip(0, 255).astype(np.uint8)
    u, v = u422[0::2], v422[0::2]
    yuy2 = np.empty((H, W, 2), np.uint8)
    yuy2[:, :, 0], yuy2[:, 0::2, 1], yuy2[:, 1::2, 1] = y, u422, v422
    uyvy = yuy2[:, :, ::-1].copy()
    for packed, unpack, order in ((yuy2, native_host.unpack_yuy2, (0, 1)),
                                  (uyvy, native_host.unpack_uyvy, (1, 0))):
        ly, lu, lv = unpack(packed)
        want = (packed[:, :, order[0]], packed[:, 0::2, order[1]], packed[:, 1::2, order[1]])
        assert all(np.array_equal(a, b) for a, b in zip((ly, lu, lv), want)), "native unpack"
    bgra = rng.integers(0, 256, size=(H, W, 4), dtype=np.uint8)
    uploads = {
        "i420": lambda d: ingest.upload_i420(y, u, v, device=d),
        "nv12": lambda d: ingest.upload_nv12(y, np.stack([u, v], -1), device=d),
        "yuy2": lambda d: ingest.upload_yuy2(yuy2, device=d),
        "uyvy": lambda d: ingest.upload_uyvy(uyvy, device=d),
        "bgra": lambda d: ingest.upload_bgra(bgra, device=d),
    }
    report, frames = {}, {}
    for name, up in uploads.items():
        got, ref = up(dev), up("cpu")
        err = float((got.pixels.cpu() - ref.pixels).abs().max())
        if got.alpha is not None:
            err = max(err, float((got.alpha.cpu() - ref.alpha).abs().max()))
        assert err <= 1.0 / 255.0, f"upload_{name}: {err} from the CPU codec"
        luma = got.pixels[0] if name != "bgra" else got.pixels[2]
        src = y if name != "bgra" else bgra[:, :, 2]
        assert float((luma.cpu() - torch.from_numpy(src.astype(np.float32) / 255.0)).abs().max()) <= 1e-7
        ms = _wall_ms(lambda: up(dev))
        report[name] = {"upload_err": err, "upload_ms": ms}
        frames[name] = (got, ref)
    downloads = {
        "i420": ingest.download_i420, "nv12": ingest.download_nv12, "yuy2": ingest.download_yuy2,
        "uyvy": ingest.download_uyvy, "bgra": ingest.download_bgra,
    }
    for name, down in downloads.items():
        got_f, ref_f = frames[name]
        outs = [down(got_f), down(ref_f)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in zip(*outs))
        assert lsb <= 1, f"download_{name}: {lsb} LSB from the CPU codec"
        report[name].update(download_lsb=lsb, download_ms=_wall_ms(lambda: down(got_f)))
    print("ingest 1080p on the card (vs the CPU codec; wall ms, median of 5): " + "; ".join(
        f"{k} up {r['upload_err']:.1e} {r['upload_ms']:.3f} ms, down {r['download_lsb']} LSB "
        f"{r['download_ms']:.3f} ms" for k, r in report.items()) + "; native host library loaded, "
        "YUY2/UYVY unpack equal to numpy", flush=True)
    return report


def _wall_ms(fn, runs: int = 5) -> float:
    """Median host wall ms of fn() with the card drained after it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_checkpoint(dev, clip, tmp) -> dict:
    """The flagship's state and the mesh stabilizer's
    (`stabilization_preset(model="field")`), each after 30 of the clip's 60
    frames, saved with its settings fingerprint, loaded into a fresh init
    of another seed, and both run over the last 30 frames: every output
    and correction bit-equal (the mesh solve sums in a fixed order, so a
    mesh run repeats bit for bit too)."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.presets import stabilization_preset
    from livevisionkit_tpu_torch.runtime import checkpoint

    fmt = lvk.PixelFormat.YUV
    n, half = clip.shape[0], clip.shape[0] // 2
    stamps = torch.arange(n, dtype=torch.float32, device=dev) / 30.0
    live = torch.ones((), dtype=torch.bool, device=dev)

    def frame(t):
        return lvk.Frame(pixels=clip[t].to(torch.float32) / 255.0, timestamp=stamps[t], valid=live,
                         format=fmt)

    spec = lvk.FrameSpec(H, W, 3, fmt)
    rep = {}
    for name, filt in (("flagship", lvk.flagship_filter()),
                       ("mesh", lvk.StabilizationFilter(settings=stabilization_preset(model="field")))):
        state = filt.init(spec, device=dev, seed=0)
        for t in range(half):
            state, _ = filt.step(state, frame(t))
        path = os.path.join(tmp, "snapshot.npz")
        t0 = time.perf_counter()
        checkpoint.save_state(path, state, filt=filt)
        t1 = time.perf_counter()
        restored = checkpoint.load_state(path, filt.init(spec, device=dev, seed=1), filt=filt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size_mb = os.path.getsize(path) / 2**20
        os.remove(path)
        bad, valid = [], 0
        for t in range(half, n):
            state, a = filt.step(state, frame(t))
            restored, b = filt.step(restored, frame(t))
            valid += int(bool(a.valid))
            if not (torch.equal(a.pixels, b.pixels) and torch.equal(a.valid, b.valid)
                    and torch.equal(a.timestamp, b.timestamp)
                    and torch.equal(state.correction.offsets, restored.correction.offsets)):
                bad.append(t)
        assert not bad, f"checkpoint ({name}): the resumed run differs at frames {bad}"
        assert valid == n - half, f"checkpoint ({name}): {valid} valid outputs after the resume"
        field = "x".join(map(str, state.correction.offsets.shape[-2:]))
        print(f"checkpoint: {name} state ({field} field) after {half} frames saved ({size_mb:.1f} "
              f"MiB, {(t1 - t0) * 1e3:.1f} ms), loaded into a fresh init ({(t2 - t1) * 1e3:.1f} "
              f"ms); the next {n - half} outputs and corrections bit-equal to the uninterrupted "
              f"run's", flush=True)
        rep[name] = {"save_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3}
    return rep


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * kx + (1 - math.cos(theta)) * (kx @ kx)


def _render_board(params, rvec, tvec, dev, supersample: int = 4) -> torch.Tensor:
    """A (H, W) f32 image of a BOARD chessboard (squares of unit side, 0.15
    and 0.85 on a 0.5 ground) seen by the camera `params` at pose (rvec,
    tvec), rendered on the card: each pixel averages supersample^2 samples,
    each undistorted by fixed-point iteration of the distortion model and
    carried onto the board plane by the inverse of its homography."""
    from livevisionkit_tpu_torch.vision.calibration import distort_normalized

    cols, rows = BOARD
    to_board = np.linalg.inv(np.c_[_rodrigues(rvec)[:, :2], tvec])
    m = [[float(v) for v in row] for row in to_board]
    yy = torch.arange(H, dtype=torch.float64, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float64, device=dev)[None, :].expand(H, W)
    acc = torch.zeros((H, W), dtype=torch.float64, device=dev)
    for i in range(supersample):
        for j in range(supersample):
            xd = (xx + ((j + 0.5) / supersample - 0.5) - params.cx) / params.fx
            yd = (yy + ((i + 0.5) / supersample - 0.5) - params.cy) / params.fy
            xu, yu = xd, yd
            for _ in range(20):
                dx, dy = distort_normalized(xu, yu, params)
                xu, yu = xu + (xd - dx), yu + (yd - dy)
            den = m[2][0] * xu + m[2][1] * yu + m[2][2]
            bx = (m[0][0] * xu + m[0][1] * yu + m[0][2]) / den
            by = (m[1][0] * xu + m[1][1] * yu + m[1][2]) / den
            on = (bx >= -1) & (bx < cols) & (by >= -1) & (by < rows) & (den > 0)
            acc += torch.where(on, 0.15 + 0.7 * ((torch.floor(bx) + torch.floor(by)) % 2), 0.5)
    return (acc / supersample ** 2).to(torch.float32)


def run_calibration(dev, rng) -> dict:
    """BOARD_VIEWS 1080p views of a 9x6 chessboard under the known camera
    CAMERA, at poses tilted up to ~26 degrees about each axis, rendered on
    the card; `find_chessboard` (its response on the card) finds every
    view, each corner within 0.5 px of its projection, and `calibrate`
    recovers fx and fy within 2%, cx and cy within 5 px and k1 within 0.05
    with RMS < 0.2 px (the JAX test's bounds, tests/test_calibration.py:
    45-53)."""
    from scipy.spatial import cKDTree

    from livevisionkit_tpu_torch.vision import calibration, chessboard

    cam = calibration.CameraParameters(**CAMERA)
    cols, rows = BOARD
    obj = np.stack(np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows)), -1).reshape(-1, 2)
    params = np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2, cam.k3])
    centre = np.array([(cols - 1) / 2, (rows - 1) / 2, 0.0])
    views, worst, t_render, t_find = [], 0.0, 0.0, 0.0
    while len(views) < BOARD_VIEWS:
        rvec = rng.uniform([-0.45, -0.45, -0.3], [0.45, 0.45, 0.3])
        z = rng.uniform(11.0, 15.0)
        at = rng.uniform([-0.35, -0.22], [0.35, 0.22])
        tvec = np.array([at[0] * z, at[1] * z, z]) - _rodrigues(rvec) @ centre
        gt = calibration._project(params, np.c_[obj, np.zeros(len(obj))], rvec, tvec)
        if gt[:, 0].min() < 40 or gt[:, 0].max() > W - 40 or gt[:, 1].min() < 40 or gt[:, 1].max() > H - 40:
            continue
        t0 = time.perf_counter()
        img = _render_board(cam, rvec, tvec, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        found = chessboard.find_chessboard(img, pattern=BOARD)
        t2 = time.perf_counter()
        t_render, t_find = t_render + t1 - t0, t_find + t2 - t1
        assert found is not None, f"calibration: the board of view {len(views)} was not found"
        d, idx = cKDTree(gt).query(found)
        assert len(np.unique(idx)) == len(gt) and d.max() < 0.5, (
            f"calibration view {len(views)}: corners {d.max():.3f} px off, {len(np.unique(idx))} distinct")
        worst = max(worst, float(d.max()))
        views.append(found)
    t0 = time.perf_counter()
    est, rms = calibration.calibrate([obj] * len(views), views, (H, W))
    t_cal = time.perf_counter() - t0
    errs = {"fx": abs(est.fx - cam.fx) / cam.fx, "fy": abs(est.fy - cam.fy) / cam.fy,
            "cx": abs(est.cx - cam.cx), "cy": abs(est.cy - cam.cy), "k1": abs(est.k1 - cam.k1)}
    assert (rms < 0.2 and errs["fx"] < 0.02 and errs["fy"] < 0.02 and errs["cx"] < 5
            and errs["cy"] < 5 and errs["k1"] < 0.05), f"calibration: {est}, RMS {rms}"
    print(f"calibration: {len(views)} 1080p views of a {cols}x{rows} board found (corners within "
          f"{worst:.3f} px of their projections; render {t_render:.2f} s, find {t_find:.2f} s); "
          f"calibrate in {t_cal:.2f} s: fx {est.fx:.2f} (err {100 * errs['fx']:.3f}%), fy "
          f"{est.fy:.2f} ({100 * errs['fy']:.3f}%), cx {est.cx:.2f}, cy {est.cy:.2f}, k1 "
          f"{est.k1:.4f}, RMS {rms:.4f} px", flush=True)
    return {"rms": rms, **errs}


def profile_runtime(dev, clip, tmp, profile_dir: str) -> None:
    """torch.profiler tables of five steps of the lvk chain's step and of
    lens correction alone in each mode (`--profile`), on YUV frames of the
    clip."""
    import livevisionkit_tpu_torch as lvk

    fmt = lvk.PixelFormat.YUV
    frames = [lvk.Frame.create(clip[t].to(torch.float32) / 255.0, timestamp=t / 30.0, fmt=fmt)
              for t in range(5)]
    spec = lvk.FrameSpec(H, W, 3, fmt)
    filters = {"lvk_chain": _lvk_chain(tmp)}
    for mode in ("easu", "bilinear"):
        filters[f"lens_correction_{mode}"] = lvk.LensCorrectionFilter(
            parameters=lvk.CameraParameters(**CAMERA), warp_filter=mode)
    for name, filt in filters.items():
        state = filt.init(spec, device=dev)
        filt.step(state, frames[0])
        _profile(filt.step, state, frames, os.path.join(profile_dir, name))


def run_runtime_slice(dev, clip, profile_dir: str | None) -> dict:
    """The runtime slice's eight phases over stream 0 of the u8 clips, on a
    generator of their own, with a temporary directory for the lc profile,
    the trace and the snapshot."""
    import tempfile

    rng = np.random.default_rng(2)
    frames = _bgr_reader_frames(clip)
    with tempfile.TemporaryDirectory() as tmp:
        if profile_dir:
            profile_runtime(dev, clip, tmp, profile_dir)
        rep = {"stream": run_lvk_stream(dev, frames, tmp),
               "profile": run_lvk_profile(dev, frames, tmp),
               "trace": run_lvk_trace(dev, frames, tmp),
               "lc": check_lens_correction(dev, clip),
               "clip": run_process_clip(dev, clip),
               "ingest": check_ingest_codecs(dev, rng),
               "checkpoint": run_checkpoint(dev, clip, tmp),
               "calibration": run_calibration(dev, rng)}
    return rep


# ------------------------------------------------------------------------
# The multi-device slice: a mesh of torch devices driven by one process
# (distinct cards when there are enough, else cuda:0 repeated), the
# tile-sharded halo remap (K1 per tile), the feature-sharded mesh solve,
# temporally sharded process_clip, the dry run and two processes.

N_TILES = 4
TILE_HALO = 192  # the dry run's halo: the corrective limit's reach at 4K
CLIP_T, CLIP_CHUNKS, CLIP_OVERLAP = 192, 4, 48  # overlap: the JAX default


def mesh_devices(dev, n: int) -> list:
    """n distinct cards when the host has them, else `dev` n times."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _sync_checked(fn):
    """fn() with synchronizing calls made errors."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_warp_tiled(dev, rng) -> dict:
    """`remap_sharded` at 3x2160x3840, YUV u8 and f32, EASU and bilinear,
    over N_TILES tiles with halo 192 under the dry run's similarity
    (1.001, 0.002, 5, -3): four K1 launches a call, each on a halo-padded
    stripe wider than its output, no host sync; the result against K1's
    solo launch on the whole frame (f32 within 1e-5, u8 within 1 LSB), and
    each tile's K1 against its plain version on the same stripe (f32
    within 1e-4, u8 1 LSB on at most 1e-3 of pixels), with the blocks that
    gather from device memory."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops import remap as remap_ops
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
    from livevisionkit_tpu_torch.parallel import spatial
    from livevisionkit_tpu_torch.parallel.streams import Mesh

    h, w = UHD
    devices = mesh_devices(dev, N_TILES)
    mesh = Mesh(devices, ("tile",))
    luma = torch.from_numpy(_texture(h, w, rng)).to(dev)
    img_f = torch.stack([luma, 0.25 + 0.5 * luma.flip(0), 0.75 - 0.5 * luma.flip(1)]).contiguous()
    img_u8 = torch.clamp(img_f * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.001, 0.002, 5.0, -3.0, dev).sample_map(UHD).contiguous()
    fmt = lvk.PixelFormat.YUV
    report = {"devices": sorted({str(d) for d in devices})}
    for mode in ("easu", "bilinear"):
        kw = dict(fill=0.0, halo=TILE_HALO, filter_mode=mode, fmt=fmt)
        rep = {}
        for name, img in (("f32", img_f), ("u8", img_u8)):
            before = warp_kernel.warp.launches
            tiled = _sync_checked(lambda: spatial.remap_sharded(img, smap, mesh, **kw))
            launched = warp_kernel.warp.launches - before
            assert launched == N_TILES, f"warp_tiled {mode} {name}: {launched} K1 launches a call"
            solo = warp_kernel.warp(img, smap, fill=0.0, filter_mode=mode, fmt=fmt)
            if name == "f32":
                err = float((tiled - solo).abs().max())
                assert err <= 1e-5, f"warp_tiled {mode} f32 differs from solo K1 by {err} > 1e-5"
            else:
                err, _ = _u8_diff(tiled, solo)
                assert err <= 1, f"warp_tiled {mode} u8 differs from solo K1 by {err} LSB"
            rep[f"{name}_vs_solo"] = err
            # Each tile's launch against its plain version on the same stripe.
            plain_err, paths = 0.0, [0, 0]
            for padded, local_map in spatial._stripes(img, smap, devices, TILE_HALO):
                k = warp_kernel.warp(padded, local_map, fill=0.0, filter_mode=mode, fmt=fmt)
                p = remap_ops.remap_plain(padded, local_map, fill=0.0, filter_mode=mode, fmt=fmt)
                if name == "f32":
                    plain_err = max(plain_err, float((k - p).abs().max()))
                else:
                    lsb, frac = _u8_diff(k, p)
                    assert lsb <= 1 and frac <= 1e-3, (
                        f"warp_tiled {mode} u8 tile: max {lsb} LSB on {frac:.2e} of pixels")
                    plain_err = max(plain_err, lsb)
                if mode == "easu" and name == "u8":
                    used, over = _paths(lambda c: warp_kernel.warp(padded, local_map, fill=0.0,
                                                                   fmt=fmt, block_paths=c),
                                        padded.device)
                    paths = [paths[0] + used, paths[1] + over]
            if name == "f32":
                assert plain_err <= 1e-4, f"warp_tiled {mode} f32 tile differs from plain by {plain_err}"
            rep[f"{name}_vs_plain"] = plain_err
            if mode == "easu" and name == "u8":
                rep["block_paths"] = paths
        stripes = spatial._stripes(img_u8, smap, devices, TILE_HALO)
        rep["ms"] = _median_ms(lambda: spatial.remap_sharded(img_u8, smap, mesh, **kw))
        rep["solo_ms"] = _median_ms(lambda: warp_kernel.warp(img_u8, smap, fill=0.0, filter_mode=mode,
                                                             fmt=fmt))
        rep["plain_ms"] = _median_ms(lambda: [remap_ops.remap_plain(p, m, fill=0.0, filter_mode=mode,
                                                                    fmt=fmt) for p, m in stripes],
                                     runs=5)
        rep["max_abs_err"] = rep["u8_vs_plain"]
        rep["call_launches"], rep["busy_ms"] = _kernel_launches(
            lambda: spatial.remap_sharded(img_u8, smap, mesh, **kw))
        src_w = stripes[0][0].shape[-1]
        print(f"K1 per tile ({mode}): {N_TILES} tiles on {report['devices']}, 3x{h}x{w // N_TILES} "
              f"outputs from 3x{h}x{src_w} padded sources, {launched} K1 launches a call; vs solo K1 "
              f"f32 {rep['f32_vs_solo']:.3e}, u8 {rep['u8_vs_solo']} LSB; tiles vs plain f32 "
              f"{rep['f32_vs_plain']:.3e}, u8 {rep['u8_vs_plain']} LSB"
              + (f"; {rep['block_paths'][1]} of {rep['block_paths'][0]} blocks gather from device "
                 f"memory" if mode == "easu" else "")
              + f"; tiled call {rep['ms']:.4f} ms ({rep['call_launches']:.0f} launches, "
              f"{rep['busy_ms']:.4f} ms device busy), solo K1 {rep['solo_ms']:.4f} ms, plain tiles "
              f"{rep['plain_ms']:.4f} ms (u8, median)", flush=True)
        report[mode] = rep
    n_easu, n_src = _easu_work(smap, h, w)
    report["easu"]["bound_ms"], report["easu"]["bound_by"] = _bound(
        img_u8.numel() * 2 + smap.numel() * 4, _easu_ops(n_easu, n_src, 3))
    print(f"K1 per tile easu: bound {report['easu']['bound_ms']:.4f} ms "
          f"({report['easu']['bound_by']}; the whole frame's bytes and operations, as solo)",
          flush=True)
    return report


def run_sharded_clip(dev, rng) -> dict:
    """`process_clip_sharded` of the flagship over a CLIP_T-frame shaky
    1080p YUV clip on the card, CLIP_CHUNKS `time` chunks, overlap 48, with
    synchronizing calls made errors, op by op (one K2 and one K3 launch a
    tick: the chunks share the card, one CLIP_CHUNKS-stream step a tick)
    and as a CUDA graph a tick (the default; launches at its capture only),
    the two bit-equal; against `process_clip` on the same clip by the JAX
    test's rule (tests/test_offline_sharded.py:60-74): >= 70% of frames
    valid in both, timestamps within 1e-6, mean pixel difference < 0.01."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.parallel.streams import Mesh
    from livevisionkit_tpu_torch.runtime.offline import process_clip, process_clip_sharded
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    n, fmt = CLIP_T, lvk.PixelFormat.YUV
    _, pixels = _shaky_render(dev, rng, n=n)
    clip = torch.stack([pixels(t) for t in range(n)])  # (192, 3, 1080, 1920) f32, 4.8 GB
    devices = mesh_devices(dev, CLIP_CHUNKS)
    mesh = Mesh(devices, ("time",))
    filt = lvk.flagship_filter()
    # One step on a throwaway state on each card fills the per-shape
    # caches (the resize weights, kept per device), so the sync-checked
    # runs below meet no first-use upload.
    for d in set(devices):
        filt.step(filt.init(lvk.FrameSpec(H, W, 3, fmt), device=d),
                  lvk.Frame.create(clip[0].to(d), timestamp=0.0, fmt=fmt))
    torch.cuda.synchronize()

    def timed(fn):
        _reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = _sync_checked(fn)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n, _launches()

    per = WARMUP_STEPS + 1  # a graph's launches: the warm-up's and the capture's
    serial, s_gpu, s_wall, s_launch = timed(lambda: process_clip(filt, clip, fmt, device=dev)[1])
    assert s_launch == _want(warp=per, lk_track=per), f"process_clip: launches {s_launch}"
    eager, e_gpu, e_wall, e_launches = timed(
        lambda: process_clip_sharded(filt, clip, fmt, mesh, overlap=CLIP_OVERLAP, jit=False))
    sharded, gpu_ms, wall_ms, launches = timed(
        lambda: process_clip_sharded(filt, clip, fmt, mesh, overlap=CLIP_OVERLAP))
    ticks = CLIP_OVERLAP + -(-n // CLIP_CHUNKS)
    groups = len(set(devices))
    if groups == 1:
        want = _want(warp_batched=ticks, lk_track=ticks)
    else:
        want = _want(warp_batched=ticks * CLIP_CHUNKS, lk_track=ticks * CLIP_CHUNKS)
    assert e_launches == want, f"process_clip_sharded (op by op): launches {e_launches}, want {want}"
    want = _want(warp_batched=per * groups, lk_track=per * groups)
    assert launches == want, f"process_clip_sharded: launches {launches}, want {want}"
    differ = [int(_bit_diff(a, b)) for a, b in zip((sharded.pixels, sharded.timestamp, sharded.valid),
                                                   (eager.pixels, eager.timestamp, eager.valid))]
    assert not any(differ), f"process_clip_sharded: graph differs from op by op in {differ} elements"
    del eager
    assert sharded.pixels.shape == serial.pixels.shape
    sv, cv = serial.valid.cpu().numpy(), sharded.valid.cpu().numpy()
    both = sv & cv
    assert both.sum() > 0.7 * n, f"process_clip_sharded: {both.sum()} of {n} frames valid in both"
    keep = torch.from_numpy(both).to(dev)
    dt = float((serial.timestamp[keep] - sharded.timestamp[keep]).abs().max())
    assert dt <= 1e-6, f"process_clip_sharded: timestamps {dt} apart"
    diff = (serial.pixels[keep] - sharded.pixels[keep]).abs().mean(dim=(1, 2, 3))
    mean_diff = float(diff.mean())
    assert mean_diff < 0.01, f"process_clip_sharded: mean pixel difference {mean_diff}"
    assert bool(torch.isfinite(sharded.pixels).all())
    print(f"process_clip_sharded: {n} 1080p frames of the flagship in {CLIP_CHUNKS} chunks on "
          f"{sorted({str(d) for d in devices})}, overlap {CLIP_OVERLAP}: {ticks} ticks, launches "
          f"{launches}; {int(cv.sum())} valid ({int(sv.sum())} serial), {int(both.sum())} in both, "
          f"mean |pixel diff| {mean_diff:.3e} (max frame {float(diff.max()):.3e}); a graph a "
          f"tick, bit-equal to op by op; {gpu_ms:.4f} ms/frame device, {wall_ms:.4f} ms/frame "
          f"host (op by op {e_gpu:.4f} / {e_wall:.4f}); process_clip {s_gpu:.4f} / "
          f"{s_wall:.4f} ms/frame (each graph call with its capture)", flush=True)
    return {"launches": launches, "gpu_ms": gpu_ms, "wall_ms": wall_ms, "serial_gpu_ms": s_gpu,
            "serial_wall_ms": s_wall, "eager_gpu_ms": e_gpu, "eager_wall_ms": e_wall,
            "mean_diff": mean_diff, "both": int(both.sum())}


def run_distributed_solve(dev, rng) -> dict:
    """`estimate_sharded` of the vector-field preset's 16x16 field from the
    510 features of a 1080p mesh step (272x480 detection), over N_TILES
    tiles (510 padded to 512 with zero-weight features), with synchronizing
    calls made errors, against the solo `mesh_motion.estimate`: offsets
    within 1e-4 detection px, the same inliers."""
    from livevisionkit_tpu_torch.models.warp_field import WarpField
    from livevisionkit_tpu_torch.parallel.distributed_solve import estimate_sharded
    from livevisionkit_tpu_torch.parallel.streams import Mesh
    from livevisionkit_tpu_torch.presets import stabilization_preset
    from livevisionkit_tpu_torch.vision import mesh_motion

    tracker = stabilization_preset(model="field").tracker
    res, det, settings = tuple(tracker.motion_resolution), tuple(tracker.detection_size), tracker.mesh
    assert res == (16, 16) and det == (272, 480)
    n = 510  # the 17x30 grid's features
    dh, dw = det
    pts = np.stack([rng.uniform(4, dw - 5, n), rng.uniform(4, dh - 5, n)], -1).astype(np.float32)
    # A pan plus a smooth local wobble; 40 gross outliers.
    disp = np.stack([3.0 + 1.5 * np.sin(pts[:, 1] / 40.0), -2.0 + 1.2 * np.cos(pts[:, 0] / 60.0)], -1)
    src = pts + disp.astype(np.float32)
    bad = rng.choice(n, 40, replace=False)
    src[bad] += rng.uniform(8, 20, size=(40, 2)).astype(np.float32)
    src_t, dst_t = torch.from_numpy(src).to(dev), torch.from_numpy(pts).to(dev)
    weights = torch.ones(n, device=dev)
    glob = WarpField.from_homography(_similarity(1.0, 0.0, 3.0, -2.0, dev), res, det)
    prev = WarpField(offsets=torch.zeros((2, *res), device=dev))
    scale = torch.ones((), device=dev)
    args = (src_t, dst_t, weights, glob, det, settings)
    devices = mesh_devices(dev, N_TILES)
    mesh = Mesh(devices, ("tile",))
    field, inl, mres = _sync_checked(lambda: estimate_sharded(*args, mesh, prev_local=prev,
                                                              prev_weight_scale=scale))
    solo, solo_inl, solo_res = mesh_motion.estimate(*args, prev, scale)
    px = torch.tensor([dh - 1, dw - 1], dtype=torch.float32, device=dev).reshape(2, 1, 1)
    err = float(((field.offsets - solo.offsets) * px).abs().max())
    assert err <= 1e-4, f"estimate_sharded: offsets {err} px from solo"
    assert torch.equal(inl, solo_inl), "estimate_sharded: inliers differ from solo"
    ms = _median_ms(lambda: estimate_sharded(*args, mesh, prev_local=prev, prev_weight_scale=scale),
                    runs=5)
    solo_ms = _median_ms(lambda: mesh_motion.estimate(*args, prev, scale), runs=5)
    print(f"estimate_sharded: {n} features over {N_TILES} tiles on {sorted({str(d) for d in devices})}"
          f", 16x16 field: offsets {err:.3e} px from solo, inliers equal ({int(inl.sum())} of {n}), "
          f"mean residual {float(mres):.4f} px (solo {float(solo_res):.4f}); {ms:.4f} ms a solve, "
          f"solo {solo_ms:.4f} ms", flush=True)
    return {"err_px": err, "ms": ms, "solo_ms": solo_ms}


def run_dryrun(dev) -> dict:
    """`dryrun_multichip(N_TILES)` at full size: the tiny flagship over a
    (2, 2) mesh at 1080p, the distributed solve, the `vs + adb + cas` chain
    over a 1 x 4 tile mesh at 4K and the 4K EASU halo remap (four K1
    launches); the meshed ticks through `jit_step` (a graph a group, its
    launches at its capture).  The flagship tick's output is held bit-equal
    against the same mesh stepped op by op, the chain's against the same
    chain stepped op by op without a mesh, and the remap within 1e-5
    against K1's solo launch."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
    from livevisionkit_tpu_torch.parallel import dryrun
    from livevisionkit_tpu_torch.parallel import streams as par
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter
    from livevisionkit_tpu_torch.utils.compiled import WARMUP_STEPS

    devices = mesh_devices(dev, N_TILES)
    _reset_launches()
    t0 = time.perf_counter()
    rep = dryrun.dryrun_multichip(N_TILES, devices, size=(H, W), uhd=UHD)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    one_card = len(set(devices)) == 1
    # One graph a group, of the flagship mesh (its rows share the card: one
    # group) and of the chain, and K1 once per tile of the halo remap; the
    # chain's deblocker (K8) and CAS (K9, batched) once a step of its graph's group.
    per = WARMUP_STEPS + 1
    groups = 2 if one_card else 3
    want = _want(warp=N_TILES, warp_batched=per * groups, lk_track=per * groups, deblock=per,
                 cas_batched=per)
    assert launches == want, f"dryrun: launches {launches}, want {want}"
    mesh, px = rep["mesh"], rep["frames"]
    n_streams = px.shape[0]
    eager = MultiStreamFilter(dryrun.tiny_flagship(), n_streams, mesh)
    frames = dryrun._frames(px)
    _, eager_out = eager.step(eager.init(lvk.FrameSpec(H, W, 1, lvk.PixelFormat.GRAY), seed=0),
                              eager._shard(frames, tile_w=True))
    eager_out = par.unshard(eager_out, px.device)
    assert torch.equal(rep["out"].pixels, eager_out.pixels) and torch.equal(rep["out"].valid, eager_out.valid), (
        "dryrun: the flagship mesh tick's graph differs from op by op")
    ref = MultiStreamFilter(rep["chain"], 1)
    ref_state = ref.init(lvk.FrameSpec(UHD[0], UHD[1], 1, lvk.PixelFormat.GRAY), device=dev, seed=0)
    _, ref_out = ref.step(ref_state, rep["chain_frames"])
    out = rep["chain_out"]
    assert torch.equal(out.pixels, ref_out.pixels) and torch.equal(out.valid, ref_out.valid), (
        "dryrun: the meshed 4K chain differs from the unmeshed one")
    img, smap, _ = rep["remap_in"]
    solo = warp_kernel.warp(img.contiguous(), smap.contiguous(), fill=0.0, fmt=lvk.PixelFormat.GRAY)
    err = float((rep["remap_out"] - solo).abs().max())
    assert err <= 1e-5, f"dryrun: 4K halo remap differs from solo K1 by {err}"
    print(f"dryrun_multichip({N_TILES}) on {sorted({str(d) for d in devices})}: {wall_s:.2f} s "
          f"(the captures included), launches {launches}; the flagship mesh tick's graph "
          f"bit-equal to op by op, the 4K chain's to the unmeshed chain op by op; halo remap vs "
          f"solo K1 {err:.3e}", flush=True)
    return {"launches": launches, "wall_s": wall_s, "remap_err": err}


def run_multiproc() -> dict:
    """tools/run_multiproc_torch.py on the card: two processes joined
    through torch.distributed (gloo, a file rendezvous), each stepping its
    own streams of a (4, 2) mesh, bit-equal to one process."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "tools", "run_multiproc_torch.py"),
                           "--device", "cuda"], capture_output=True, text=True, timeout=600, cwd=root)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0 or "MULTIPROC OK" not in proc.stdout:
        raise RuntimeError(f"run_multiproc_torch.py exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    print(f"multiproc: {proc.stdout.strip().splitlines()[-1]} ({wall_s:.1f} s)", flush=True)
    return {"wall_s": wall_s}


def run_multidevice_slice(dev) -> dict:
    """The multi-device slice's five phases, on a generator of their own."""
    rng = np.random.default_rng(3)
    n_cards = torch.cuda.device_count()
    print(f"multi-device meshes: {n_cards} card(s); "
          + ("distinct cards" if n_cards >= N_TILES else f"{dev} repeated {N_TILES} times"),
          flush=True)
    return {"tiled": check_warp_tiled(dev, rng), "clip": run_sharded_clip(dev, rng),
            "solve": run_distributed_solve(dev, rng), "dryrun": run_dryrun(dev),
            "multiproc": run_multiproc()}


def check_sync_capture(dev) -> None:
    """A step that synchronizes, the flagship's with a host read of its
    output's valid flag, raises at its first call and makes no graph; then
    the card still steps."""
    import livevisionkit_tpu_torch as lvk
    from livevisionkit_tpu_torch.utils.compiled import jit_step

    filt = lvk.flagship_filter()
    spec = lvk.FrameSpec(H, W, 3, lvk.PixelFormat.YUV)
    frame = lvk.Frame.create(torch.full((3, H, W), 0.5, device=dev), fmt=lvk.PixelFormat.YUV)

    def reads_back(state, fr):
        state, out = filt.step(state, fr)
        if bool(out.valid):  # a device value read on the host
            out = out.replace(pixels=out.pixels * 1.0)
        return state, out

    step = jit_step(reads_back)
    try:
        step(filt.init(spec, device=dev), frame)
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    else:
        raise AssertionError("a synchronizing step was captured")
    assert step.n_graphs == 0, "a synchronizing step left a graph"
    ok = jit_step(filt.step)
    _, out = ok(filt.init(spec, device=dev), frame)
    torch.cuda.synchronize()
    assert ok.n_graphs == 1 and out.pixels.shape == (3, H, W)
    print(f"sync check: a step reading a device value back raised at its first call ({err!r}) "
          f"and made no graph; the flagship's graph captured after it", flush=True)


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
    ransac_rep = check_ransac(dev, np.random.default_rng(3))
    deblock_rep = check_deblock(dev, np.random.default_rng(4))
    cas_rep = check_cas(dev, np.random.default_rng(5))
    cas_b_rep = check_cas_x8(dev, np.random.default_rng(6))
    poses, clips = _shaky_clips_u8(dev, rng)
    # The solo step and the 8-stream tick alternate, since the host's pace
    # wanders between phases of one process.
    pairs = []
    for k in range(2):
        profile = args.profile if k == 0 else None
        pairs.append((run_slice(dev, rng, profile, graph=k == 0),
                      run_multistream(dev, poses, clips, profile, graph=k == 0)))
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
    sv = run_serving_tools(dev, clips)
    bt = run_bench_tools(dev)
    # The enhancement filters, on a generator of their own so that the
    # phases above see the data they always saw.
    rng_e = np.random.default_rng(1)
    k1_c4, k2_c4 = check_warp_c4(dev, rng_e)
    fc = run_full_chain(dev, rng_e, args.profile)
    alone = check_filters_alone(dev, rng_e, fc.pop("frame0"))
    adb = run_adb_cas_multistream(dev, poses, clips, args.profile)
    dbg = run_debug(dev, rng_e, clips)
    rt = run_runtime_slice(dev, clips[0], args.profile)
    del clips
    md = run_multidevice_slice(dev)
    check_sync_capture(dev)

    def entry(name, source, replaces, launches, rep, library_ms=None):
        # K7, K8 and K9 replace no TPU kernel: XLA fuses the JAX package's
        # RANSAC, its deblocker and its CAS.
        return {"name": name, "route": "cuda", "source": f"livevisionkit_tpu_torch/csrc/{source}",
                "replaces": f"livevisionkit_tpu/ops/tpu_kernels/{replaces}" if replaces else None,
                "launches": launches,
                "max_abs_err": rep["max_abs_err"], "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"], "library_ms": library_ms}

    def launched(kernel, *paths):
        return sum(r["launches"][kernel] for r in paths)

    # Launches: the kernel's count over every path that launches it (the
    # scaler alone is part of the chain's report).  No single PyTorch call
    # computes the EASU warp or upscale, LK or RCAS: library_ms is null; the
    # bilinear warp's grid_sample time is printed above.
    # The debug phase's K1 and K2 launches are all at four planes (colour +
    # alpha): the C = 4 rows.
    # The runtime slice's counted drives: the lvk stream (K1 twice a frame),
    # lens correction alone in EASU mode and process_clip; lens correction
    # in bilinear mode is the warp_bilinear row.  The serving tools' graph
    # captures: solo (stream()) and batched (stream_multi, scaling ticks).
    paths = (sl, ms, ch, chx, me, mex, fc, adb, rt["stream"], rt["lc"]["easu"], rt["clip"])
    debug_lk = dbg["solo_launches"]["lk_track"]
    debug_lk_x8 = dbg["multi_launches"]["lk_track"]
    easu_2x = dict(easu_rep[OUT], max_abs_err=max(r["max_abs_err"] for r in easu_rep.values()))

    def ladder(kernel, *configs):
        return sum(bt["ladder"][c]["launches"][kernel] for c in configs)

    kernels = [
        entry("warp", "warp.cu", "warp.py:312", launched("warp", *paths) + sv["solo_launches"]["warp"],
              warp_rep["easu"]),
        entry("warp_batched", "warp.cu", "warp.py:829",
              launched("warp_batched", *paths) + sv["multi_launches"]["warp_batched"],
              warp_b_rep["easu"]),
        entry("warp_c4", "warp.cu", "warp.py:312", dbg["solo_launches"]["warp"], k1_c4["flagship"]),
        entry("warp_batched_c4", "warp.cu", "warp.py:829", dbg["multi_launches"]["warp_batched"],
              k2_c4),
        # K2 in bilinear mode: the serving split's bilinear tick and
        # profile_warp's K2 rows (run_bench_tools).
        entry("warp_batched_bilinear", "warp.cu", "warp.py:489",
              bt["launches"]["warp_batched_bilinear"], warp_b_rep["bilinear"]),
        entry("warp_bilinear", "warp.cu", "warp.py:81", rt["lc"]["bilinear"]["launches"]["warp"],
              rt["lc"]["bilinear"], library_ms=rt["lc"]["bilinear"]["library_ms"]),
        entry("lk_track", "lk.cu", "lk.py:255",
              launched("lk_track", sl, ch, me, fc, rt["stream"], rt["clip"]) + debug_lk
              + sv["solo_launches"]["lk_track"] + ladder("lk_track", *NEW_LADDER), lk_rep["lk_track"]),
        entry("lk_track_x8", "lk.cu", "lk.py:255", launched("lk_track", ms, chx, mex, adb) + debug_lk_x8
              + sv["multi_launches"]["lk_track"], lk_b_rep),
        # K4 is K3's n_levels = 1 call.
        entry("lk_level", "lk.cu", "lk.py:201", launched("lk_level", *paths), lk_rep["lk_level"]),
        entry("easu_scale", "easu_scale.cu", "easu_scale.py:264",
              launched("easu_scale", *paths) + ch["scaler_launches"]["easu_scale"], easu_2x),
        entry("easu_scale_x8", "easu_scale.cu", "easu_scale.py:264",
              launched("easu_scale_batched", *paths), easu_b_rep),
        entry("rcas", "rcas.cu", "rcas.py:108",
              launched("rcas", *paths) + ch["scaler_launches"]["rcas"], rcas_rep),
        entry("rcas_x8", "rcas.cu", "rcas.py:108", launched("rcas_batched", *paths), rcas_b_rep),
        # K7 wherever the tracker runs, as K3: solo and over 8 streams.
        entry("ransac", "ransac.cu", None,
              launched("ransac", sl, ch, me, fc, rt["stream"], rt["clip"])
              + dbg["solo_launches"]["ransac"] + sv["solo_launches"]["ransac"]
              + ladder("ransac", *NEW_LADDER), ransac_rep["solo"]),
        entry("ransac_x8", "ransac.cu", None,
              launched("ransac", ms, chx, mex, adb) + dbg["multi_launches"]["ransac"]
              + sv["multi_launches"]["ransac"], ransac_rep["x8"]),
        # K8: the median alone in profile_enhance's rows; the deblocker
        # (reduce + blend, a call) in the 4K chain, the vs + adb + cas tick,
        # the lvk stream, the bench matrix's three deblocker configs and
        # the dry run's chain.
        entry("median_blur", "deblock.cu", None, bt["launches"]["median_blur"],
              deblock_rep["median"], library_ms=deblock_rep["median"]["library_ms"]),
        entry("deblock", "deblock.cu", None,
              launched("deblock", *paths) + bt["launches"]["deblock"]
              + md["dryrun"]["launches"]["deblock"], deblock_rep["deblock"],
              library_ms=deblock_rep["deblock"]["library_ms"]),
        # K9 replaces no TPU kernel (XLA fuses the JAX package's CAS): solo
        # in the 4K chain and the bench matrix's 4k_cas and 4K chain; over
        # STREAMS streams in the vs + adb + cas tick and the dry run's chain.
        entry("cas", "cas.cu", None, launched("cas", *paths) + bt["launches"]["cas"], cas_rep),
        entry("cas_x8", "cas.cu", None,
              launched("cas_batched", *paths) + md["dryrun"]["launches"]["cas_batched"], cas_b_rep),
        # K1 once per tile of remap_sharded: the dry run's 4K halo remap.
        entry("warp_tiled", "warp.cu", "warp.py:312", md["dryrun"]["launches"]["warp"],
              md["tiled"]["easu"]),
        # K1 at the new ladder configs' shapes (run_bench_tools): GRAY at
        # 480x640, u8 EASU at 4K, and the stabilizer's bilinear u8 warp.
        entry("warp_gray", "warp.cu", "warp.py:312",
              ladder("warp", "640x480_gray_stabilization"), bt["k1"]["warp_gray"]),
        entry("warp_4k", "warp.cu", "warp.py:312",
              ladder("warp", "4k_homography_stabilization", "4k_mesh_stabilization"),
              bt["k1"]["warp_4k"]),
        entry("warp_bilinear_u8", "warp.cu", "warp.py:81",
              ladder("warp", "1080p_homography_stabilization_bilinear",
                     "1080p_mesh_stabilization_bilinear"), bt["k1"]["warp_bilinear_u8"]),
        entry("warp_bilinear_u8_4k", "warp.cu", "warp.py:81",
              ladder("warp", "4k_homography_stabilization_bilinear",
                     "4k_mesh_stabilization_bilinear"), bt["k1"]["warp_bilinear_u8_4k"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{gpu} | slice {sl['gpu_ms']:.4f} ms/frame (device), {sl['wall_ms']:.4f} ms/frame (host)"
          f" | {STREAMS}-stream tick {ms['gpu_ms']:.4f} / {ms['wall_ms']:.4f} ms"
          f" | chain {ch['gpu_ms']:.4f} / {ch['wall_ms']:.4f} | scaler alone "
          f"{ch['scaler_gpu_ms']:.4f} / {ch['scaler_wall_ms']:.4f}"
          f" | {STREAMS}-stream chain tick {chx['gpu_ms']:.4f} / {chx['wall_ms']:.4f}"
          f" | mesh {me['gpu_ms']:.4f} / {me['wall_ms']:.4f}"
          f" | {STREAMS}-stream mesh tick {mex['gpu_ms']:.4f} / {mex['wall_ms']:.4f}"
          f" | stream_multi {sm['fps']:.1f} frames/s"
          f" | serving: loopback {sv['loopback']['stalls']} stalls, soak {sv['soak']['sessions']} "
          f"sessions of {STREAMS} x {SOAK_FRAMES} with no frame lost, end to end "
          f"{sv['e2e']['steady_state_fps']:.1f} frames/s steady (target 480, transfer floor "
          f"{sv['e2e']['transfer_floor_ms']:.2f} ms), scaling efficiency "
          + "/".join(f"{r['scaling_efficiency']:.3f}" for r in sv["scaling"])
          + f" at S={'/'.join(str(r['streams']) for r in sv['scaling'])} (target 0.8), paced "
          f"{LATENCY_FPS:.0f} fps p50/p95/p99 identity "
          + "/".join(f"{sv['latency'][3][0][k]:.2f}" for k in ("p50_ms", "p95_ms", "p99_ms"))
          + ", flagship " + "/".join(f"{sv['latency'][3][1][k]:.2f}" for k in ("p50_ms", "p95_ms", "p99_ms"))
          + " ms (limit 66.7), in flight 0 identity "
          + "/".join(f"{sv['latency'][0][0][k]:.2f}" for k in ("p50_ms", "p95_ms", "p99_ms"))
          + ", flagship " + "/".join(f"{sv['latency'][0][1][k]:.2f}" for k in ("p50_ms", "p95_ms", "p99_ms"))
          + " ms (limit 16.7)"
          + f" | K3 x{STREAMS} {lk_b_rep['ms']:.4f} ms"
          f" | K5 x{STREAMS} {easu_b_rep['ms']:.4f} ms | K6 x{STREAMS} {rcas_b_rep['ms']:.4f} ms"
          f" | K7 {ransac_rep['solo']['ms']:.4f} ms, x{STREAMS} {ransac_rep['x8']['ms']:.4f} ms"
          f" | K8 median {deblock_rep['median']['ms']:.4f} ms, deblock 4K "
          f"{deblock_rep['deblock']['ms']:.4f} ms"
          f" | K9 cas 4K {cas_rep['ms']:.4f} ms, x{STREAMS} 1080p {cas_b_rep['ms']:.4f} ms"
          f" | 4K full chain {fc['gpu_ms']:.4f} / {fc['wall_ms']:.4f}"
          f" | {STREAMS}-stream vs+adb+cas tick {adb['gpu_ms']:.4f} / {adb['wall_ms']:.4f}"
          f" | deblock 1080p {alone['deblock_1080p']['ms']:.4f} ms, 4K {alone['deblock_4k']['ms']:.4f}"
          f" | CAS 4K {alone['cas_4k']['ms']:.4f} | K1 C=4 {k1_c4['flagship']['ms']:.4f}"
          f" | K2 x{STREAMS} C=4 {k2_c4['ms']:.4f}"
          f" | lvk stream (lc+vs+adb) {rt['stream']['fps']:.2f} frames/s, p50/p95/p99 "
          f"{rt['stream']['p50_ms']:.2f}/{rt['stream']['p95_ms']:.2f}/{rt['stream']['p99_ms']:.2f} ms"
          f" | lc K1 easu {rt['lc']['easu']['ms']:.4f}, bilinear {rt['lc']['bilinear']['ms']:.4f} ms"
          f" | process_clip {rt['clip']['gpu_ms']:.4f} / {rt['clip']['wall_ms']:.4f} ms/frame"
          f" | K1 per tile x{N_TILES} 4K {md['tiled']['easu']['ms']:.4f} ms (solo "
          f"{md['tiled']['easu']['solo_ms']:.4f})"
          f" | process_clip_sharded x{CLIP_CHUNKS} {md['clip']['gpu_ms']:.4f} / "
          f"{md['clip']['wall_ms']:.4f} ms/frame (serial {md['clip']['serial_gpu_ms']:.4f} / "
          f"{md['clip']['serial_wall_ms']:.4f})"
          f" | estimate_sharded {md['solve']['ms']:.4f} ms (solo {md['solve']['solo_ms']:.4f})"
          f" | dryrun {md['dryrun']['wall_s']:.2f} s | multiproc {md['multiproc']['wall_s']:.1f} s",
          flush=True)
    graphs = [("slice", sl), ("8-stream tick", ms), ("chain", ch), ("8-stream chain tick", chx),
              ("mesh", me), ("8-stream mesh tick", mex), ("4K full chain", fc),
              ("8-stream vs+adb+cas tick", adb)]
    print(f"{gpu} | op by op -> CUDA graph, ms/frame (ms/tick) device / host: "
          + " | ".join(f"{name} {r['gpu_ms']:.4f} / {r['wall_ms']:.4f} -> {r['graph']['gpu_ms']:.4f}"
                       f" / {r['graph']['wall_ms']:.4f}" for name, r in graphs)
          + f" | lvk chain step -> {rt['stream']['graph']['gpu_ms']:.4f} / "
          f"{rt['stream']['graph']['wall_ms']:.4f}"
          f" | lvk stream {rt['stream']['eager']['steady_ms']:.4f} -> {rt['stream']['steady_ms']:.4f}"
          f" ms/frame host ({rt['stream']['eager']['fps']:.2f} -> {rt['stream']['fps']:.2f} frames/s"
          f" over the run)"
          f" | stream_multi {sm['eager']['steady_ms']:.4f} -> {sm['steady_ms']:.4f} ms/tick host"
          f" ({sm['eager']['fps']:.1f} -> {sm['fps']:.1f} frames/s)"
          f" | process_clip {rt['clip']['eager_gpu_ms']:.4f} / {rt['clip']['eager_wall_ms']:.4f} ->"
          f" {rt['clip']['gpu_ms']:.4f} / {rt['clip']['wall_ms']:.4f}"
          f" | process_clip_sharded x{CLIP_CHUNKS} {md['clip']['eager_gpu_ms']:.4f} /"
          f" {md['clip']['eager_wall_ms']:.4f} -> {md['clip']['gpu_ms']:.4f} /"
          f" {md['clip']['wall_ms']:.4f}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
