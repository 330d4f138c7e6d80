"""Launch wrapper of the whole-pyramid Lucas-Kanade kernel (csrc/lk.cu).

Replaces livevisionkit_tpu/ops/tpu_kernels/lk.py::lk_track (body
``_lk_pyramid_kernel``) and, as its ``n_levels = 1`` call, ``lk_level``
(``_lk_kernel``).  Its plain version is vision/optical_flow.track_plain.

What bounds it on the H100: per feature and level it gathers a 13x13
template patch and, per Gauss-Newton iteration, a 12x12 search window
(4 taps per bilinear sample) — some 3,500 dependent 4-byte gathers per
feature per level, with a few FLOPs each.  At 510 features that is far too
little work to fill 132 SMs, so it is bound by gather latency and launch
overhead, not bandwidth.  Its design: one warp per feature walks all
levels in one launch (no per-level launches or host round trips), keeps
the template and gradients in shared memory, and reduces with warp
shuffles, so no block-wide barrier or atomics are needed.
"""

from __future__ import annotations

import ctypes

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build

_MAX_LEVELS = 8
_MAX_WINDOW = 31


def lk_track(
    prev_levels: tuple[torch.Tensor, ...],
    next_levels: tuple[torch.Tensor, ...],
    pts: torch.Tensor,
    init_flow: torch.Tensor,
    window_size: int,
    iterations: int,
    min_eigen_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track (N, 2) level-0 points through two CUDA pyramids; returns the
    (N, 2) level-0 flow and the (N,) bool status (gradient-conditioned and
    in-bounds at every level)."""
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
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("LK kernel takes contiguous f32 tensors")
    for a, b in zip(prev_levels, next_levels):
        if a.ndim != 2 or a.shape != b.shape:
            raise ValueError("pyramid levels must be matching (H, W) planes")
    n = pts.shape[0]
    if pts.shape != (n, 2) or init_flow.shape != (n, 2):
        raise ValueError("pts and init_flow must both be (N, 2)")
    flow = torch.empty((n, 2), dtype=torch.float32, device=dev)
    good = torch.empty((n,), dtype=torch.uint8, device=dev)
    ptrs = ctypes.c_void_p * n_levels
    ints = ctypes.c_int * n_levels
    lib = build.library()
    status = lib.lvk_lk_track(
        ptrs(*[t.data_ptr() for t in prev_levels]),
        ptrs(*[t.data_ptr() for t in next_levels]),
        ints(*[t.shape[0] for t in prev_levels]),
        ints(*[t.shape[1] for t in prev_levels]),
        n_levels, pts.data_ptr(), init_flow.data_ptr(), flow.data_ptr(), good.data_ptr(),
        n, window_size, iterations, float(min_eigen_threshold),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "lk_track")
    lk_track.launches += 1
    return flow, good.bool()


lk_track.launches = 0
