"""Launch wrapper of the whole-pyramid Lucas-Kanade kernel (csrc/lk.cu).

Replaces livevisionkit_tpu/ops/tpu_kernels/lk.py::lk_track (body
``_lk_pyramid_kernel``) and, as its ``n_levels = 1`` call, ``lk_level``
(``_lk_kernel``).  Its plain version is vision/optical_flow.track_plain
(under torch.func.vmap for a batch of streams).

What bounds it on the H100: latency.  Per feature and level it samples a
13x13 template patch and, per Gauss-Newton iteration, an 11x11 search
window (4 taps a bilinear sample), 15 dependent iterations over 3 levels;
at 510 features that is a few KB a feature and far too little work to
fill 132 SMs, so the time is the chain of round trips to memory, not
bandwidth or arithmetic.  Its design: one warp per feature walks all
levels in one launch; per level it stages the template's texels and a
search box around the starting iterate in shared memory in one round
trip, so the iterations read shared memory only, with the template and
its gradients in registers; a window that leaves the box has the box
staged again around it (`restaged` counts such features).  The warp's
lanes reduce with shuffles, so no block-wide barrier is needed.  The
features of S streams go in one launch (the grid's y axis), which fills S
times as many warps.
"""

from __future__ import annotations

import ctypes

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_LEVELS = 8
_MAX_WINDOW = 31
_MAX_STREAMS = 65535


def lk_track(
    prev_levels: tuple[torch.Tensor, ...],
    next_levels: tuple[torch.Tensor, ...],
    pts: torch.Tensor,
    init_flow: torch.Tensor,
    window_size: int,
    iterations: int,
    min_eigen_threshold: float,
    restaged: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track level-0 points through two CUDA pyramids, in one launch.

    Solo: (H_l, W_l) levels and (N, 2) points and initial flow; returns the
    (N, 2) level-0 flow and the (N,) bool status (gradient-conditioned and
    in-bounds at every level).  Batched over S streams: (S, H_l, W_l)
    levels and (S, N, 2) points and flow; returns (S, N, 2) and (S, N).  A
    batched operand may be broadcast over streams (stream stride 0).

    `restaged`, a (1,) int32 tensor on the points' device, makes the launch
    add to it the features whose search window left its staged box at
    least once and was staged again."""
    n_levels = len(prev_levels)
    if n_levels != len(next_levels) or not 1 <= n_levels <= _MAX_LEVELS:
        raise ValueError(f"need 1..{_MAX_LEVELS} levels in both pyramids")
    if not 1 <= window_size <= _MAX_WINDOW:
        raise ValueError(f"window_size must be in 1..{_MAX_WINDOW}, got {window_size}")
    dev = pts.device
    tensors = (*prev_levels, *next_levels, pts, init_flow)
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("LK kernel needs every tensor on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError("LK kernel takes f32 tensors")
    if restaged is not None and not (restaged.device == dev and restaged.dtype == torch.int32
                                     and restaged.shape == (1,)):
        raise ValueError("restaged must be a (1,) int32 tensor on the points' device")
    batched = pts.ndim == 3
    lead = 1 if batched else 0
    s = pts.shape[0] if batched else 1
    n = pts.shape[lead]
    if pts.shape[lead:] != (n, 2) or init_flow.shape != pts.shape or not 1 <= s <= _MAX_STREAMS:
        raise ValueError("pts and init_flow must both be (N, 2), or (S, N, 2) for S streams")
    for a, b in zip(prev_levels, next_levels):
        if a.ndim != 2 + lead or a.shape != b.shape or (batched and a.shape[0] != s):
            raise ValueError("pyramid levels must be matching (H, W) planes, (S, H, W) batched")
    for t in tensors:
        if not (blocks_contiguous(t) if batched else t.is_contiguous()):
            raise ValueError("LK kernel needs each stream's planes and point sets contiguous")
    flow = torch.empty((s, n, 2), dtype=torch.float32, device=dev)
    good = torch.empty((s, n), dtype=torch.bool, device=dev)  # the kernel writes 0 / 1 bytes
    status = launch(build.library(), prev_levels, next_levels, pts, init_flow, flow, good,
                    window_size, iterations, min_eigen_threshold, restaged)
    build.check(status, "lk_track")
    if n_levels == 1:
        lk_track.launches_one_level += 1
    else:
        lk_track.launches += 1
    if not batched:
        flow, good = flow[0], good[0]
    return flow, good


# Launches of K3 (two or more levels) and of K4 (its one-level call).
lk_track.launches = 0
lk_track.launches_one_level = 0


def launch(lib, prev_levels, next_levels, pts, init_flow, flow, good, window_size: int,
           iterations: int, min_eigen_threshold: float, restaged=None) -> int:
    """One call of `lib`'s LK entry point on tensors laid out as lk_track
    checks them, writing the (S, N, 2) f32 `flow` and the (S, N) one-byte
    `good`; returns the entry point's CUDA status.  `lib` may be a build of
    an earlier version of csrc/ that exports `lvk_lk_track`, the same call
    without the restaged count."""
    n_levels = len(prev_levels)
    batched = pts.ndim == 3
    s, n = good.shape
    ptrs = ctypes.c_void_p * n_levels
    ints = ctypes.c_int * n_levels
    strides = ctypes.c_longlong * n_levels
    sstride = (lambda t: t.stride(0)) if batched else (lambda t: 0)
    args = (
        ptrs(*[t.data_ptr() for t in prev_levels]),
        ptrs(*[t.data_ptr() for t in next_levels]),
        strides(*[sstride(t) for t in prev_levels]),
        strides(*[sstride(t) for t in next_levels]),
        ints(*[t.shape[-2] for t in prev_levels]),
        ints(*[t.shape[-1] for t in prev_levels]),
        n_levels, s, pts.data_ptr(), sstride(pts), init_flow.data_ptr(), sstride(init_flow),
        flow.data_ptr(), good.data_ptr(), n, window_size, iterations, float(min_eigen_threshold),
    )
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    if not hasattr(lib, "lvk_lk_track_counted"):
        if restaged is not None:
            raise ValueError("this LK build does not count restaged features")
        with torch.cuda.device(pts.device):
            return lib.lvk_lk_track(*args, stream)
    counter = None if restaged is None else restaged.data_ptr()
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(pts.device):
        return lib.lvk_lk_track_counted(*args, counter, stream)
