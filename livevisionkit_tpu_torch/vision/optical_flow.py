"""Sparse pyramidal Lucas-Kanade optical flow over a feature grid
(counterpart of livevisionkit_tpu/vision/optical_flow.py; reference
cv::SparsePyrLKOpticalFlow as FrameTracker uses it: 11x11 window, 3 levels,
5 iterations).

Per level and feature: a (win+2)^2 template patch bilinearly sampled at the
sub-pixel point with replicate-clamped taps, patch-local Scharr gradients,
the 2x2 gradient matrix with min-eigenvalue rejection, then frozen-Jacobian
Gauss-Newton steps that sample the search window from the next level, with
a closed-form 2x2 solve.  Lost features are masked, never removed.

`track` goes through the custom op ``lvk::lk_track``: CUDA tensors launch
the whole-pyramid kernel (ops/cuda_kernels/lk.py), CPU tensors take
`track_plain`, the kernel's reference (direct clamped gathers, batched over
the features).  Its vmap rule turns `torch.func.vmap` over streams into one
call of ``lvk::lk_track_batched``: one launch for the features of all S
streams on the card, `track_plain` under vmap on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.config import OpticalFlowSettings
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass, stream_first

_SCHEMA = ("(Tensor[] prev, Tensor[] next, Tensor pts, Tensor init_flow, int window_size, "
           "int iterations, float min_eigen_threshold) -> (Tensor, Tensor)")


@pytree_dataclass()
@dataclass(frozen=True)
class Pyramid:
    """Per-frame image pyramid (the tracking state carried between frames)."""

    levels: tuple[torch.Tensor, ...]  # (H/2^l, W/2^l) luma, level 0 first

    @classmethod
    def build(cls, gray: torch.Tensor, num_levels: int) -> "Pyramid":
        return cls(levels=tuple(resample.build_pyramid(gray.contiguous(), num_levels)))


def _bilinear_patches(
    img: torch.Tensor, base_xy: torch.Tensor, frac_xy: torch.Tensor, size: int
) -> torch.Tensor:
    """(N, size, size) patches: patch[n, i, j] samples img at
    (base + (j, i) + frac), each of the 4 taps clamped to the image."""
    h, w = img.shape
    k = torch.arange(size + 1, device=img.device)
    xs = torch.clamp(base_xy[:, 0:1] + k, 0, w - 1)  # (N, size+1)
    ys = torch.clamp(base_xy[:, 1:2] + k, 0, h - 1)
    blk = img.reshape(-1)[ys[:, :, None] * w + xs[:, None, :]]  # (N, size+1, size+1)
    fx = frac_xy[:, 0, None, None]
    fy = frac_xy[:, 1, None, None]
    b00, b01 = blk[:, :-1, :-1], blk[:, :-1, 1:]
    b10, b11 = blk[:, 1:, :-1], blk[:, 1:, 1:]
    top = b00 + (b01 - b00) * fx
    bot = b10 + (b11 - b10) * fx
    return top + (bot - top) * fy


def _patch_scharr(bwin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) Scharr gradients (1/32) of the interior of (N, win+2, win+2)
    patches."""
    sv = (3.0 * bwin[:, :-2, :] + 10.0 * bwin[:, 1:-1, :] + 3.0 * bwin[:, 2:, :]) / 32.0
    gx = sv[:, :, 2:] - sv[:, :, :-2]
    dv = bwin[:, 2:, :] - bwin[:, :-2, :]
    gy = (3.0 * dv[:, :, :-2] + 10.0 * dv[:, :, 1:-1] + 3.0 * dv[:, :, 2:]) / 32.0
    return gx, gy


def _split(p: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    fl = torch.floor(p)
    return fl.to(torch.int64) - r, p - fl


def _track_level(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    pts: torch.Tensor,  # (N, 2) positions at THIS level's scale
    guess: torch.Tensor,  # (N, 2) incoming flow at this level's scale
    settings: OpticalFlowSettings,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level of LK for all features; returns (flow, good)."""
    win = settings.window_size
    area = win * win
    r = win // 2
    h, w = prev_img.shape

    base_t, frac_t = _split(pts, r)
    bwin = _bilinear_patches(prev_img, base_t - 1, frac_t, win + 2)  # (N, win+2, win+2)
    tmpl = bwin[:, 1:-1, 1:-1]
    gx, gy = _patch_scharr(bwin)

    gxx = (gx * gx).sum(dim=(1, 2))
    gxy = (gx * gy).sum(dim=(1, 2))
    gyy = (gy * gy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) / 2.0
    good = (min_eig / area) >= settings.min_eigen_threshold
    inv_det = torch.where(det > 1e-12, 1.0 / det, 0.0)

    g = guess
    for _ in range(settings.iterations):
        base_w, frac_w = _split(pts + g, r)
        warped = _bilinear_patches(next_img, base_w, frac_w, win)
        rr = tmpl - warped
        bx = (rr * gx).sum(dim=(1, 2))
        by = (rr * gy).sum(dim=(1, 2))
        du = (gyy * bx - gxy * by) * inv_det
        dv = (gxx * by - gxy * bx) * inv_det
        g = g + torch.stack([du, dv], dim=-1)

    target = pts + g
    inside = (
        (target[:, 0] >= 0.0) & (target[:, 0] <= w - 1.0)
        & (target[:, 1] >= 0.0) & (target[:, 1] <= h - 1.0)
    )
    return g, good & inside


def track_plain(
    prev: Pyramid,
    nxt: Pyramid,
    pts: torch.Tensor,
    settings: OpticalFlowSettings,
    init_flow: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The LK kernel's plain version on any device: (N, 2) level-0 flow and
    the (N,) status of every level (gradient-conditioned, in bounds)."""
    top = len(prev.levels) - 1
    flow = torch.zeros_like(pts) if init_flow is None else init_flow.to(pts.dtype) / 2.0**top
    good = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for lvl in range(top, -1, -1):
        s = 2.0**lvl
        flow, good_l = _track_level(prev.levels[lvl], nxt.levels[lvl], pts / s, flow, settings)
        good = good & good_l
        if lvl > 0:
            flow = flow * 2.0
    return flow, good


def track_batched_plain(
    prev_levels, next_levels, pts: torch.Tensor, settings: OpticalFlowSettings,
    init_flow: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`track_plain` over a leading stream axis, by torch.func.vmap:
    (S, H_l, W_l) levels and (S, N, 2) points give (S, N, 2) flow and
    (S, N) status.  The batched rule's CPU path, and the reference the
    kernel's stream axis is held against on the card."""
    if init_flow is None:
        init_flow = torch.zeros_like(pts)
    return torch.func.vmap(
        lambda p, q, x, f: track_plain(Pyramid(tuple(p)), Pyramid(tuple(q)), x, settings, f)
    )(list(prev_levels), list(next_levels), pts, init_flow)


def _settings(window_size: int, iterations: int, min_eigen_threshold: float) -> OpticalFlowSettings:
    return OpticalFlowSettings(window_size=window_size, iterations=iterations,
                               min_eigen_threshold=min_eigen_threshold)


@torch.library.custom_op("lvk::lk_track", mutates_args=(), schema=_SCHEMA)
def _lk_op(prev, next, pts, init_flow, window_size, iterations, min_eigen_threshold):  # noqa: A002
    """One stream: the LK kernel for CUDA tensors, `track_plain` for CPU ones."""
    if pts.is_cuda:
        return lk_kernel.lk_track(tuple(prev), tuple(next), pts.contiguous(),
                                  init_flow.contiguous(), window_size, iterations,
                                  min_eigen_threshold)
    return track_plain(Pyramid(tuple(prev)), Pyramid(tuple(next)), pts,
                       _settings(window_size, iterations, min_eigen_threshold), init_flow)


@torch.library.custom_op("lvk::lk_track_batched", mutates_args=(), schema=_SCHEMA)
def _lk_batched_op(prev, next, pts, init_flow, window_size, iterations,  # noqa: A002
                   min_eigen_threshold):
    """S streams, stream axis first: one launch of the LK kernel for CUDA
    tensors, `track_plain` under vmap for CPU ones."""
    if pts.is_cuda:
        return lk_kernel.lk_track(tuple(prev), tuple(next), pts, init_flow, window_size,
                                  iterations, min_eigen_threshold)
    return track_batched_plain(prev, next, pts,
                               _settings(window_size, iterations, min_eigen_threshold), init_flow)


@_lk_op.register_fake
@_lk_batched_op.register_fake
def _lk_fake(prev, next, pts, init_flow, window_size, iterations, min_eigen_threshold):  # noqa: A002
    return pts.new_empty(pts.shape), pts.new_empty(pts.shape[:-1], dtype=torch.bool)


def _lk_vmap(info, in_dims, prev, next, pts, init_flow, window_size, iterations,  # noqa: A002
             min_eigen_threshold):
    """vmap rule of ``lvk::lk_track``: the features of all streams in one
    batched call; unbatched operands are broadcast at stream stride 0."""
    n = info.batch_size

    def levels(ts, dims):
        dims = dims if isinstance(dims, (list, tuple)) else [dims] * len(ts)
        return [stream_first(t, d, n) for t, d in zip(ts, dims)]

    prev_b, next_b = levels(prev, in_dims[0]), levels(next, in_dims[1])
    out = _lk_batched_op(prev_b, next_b, stream_first(pts, in_dims[2], n),
                         stream_first(init_flow, in_dims[3], n), window_size, iterations,
                         min_eigen_threshold)
    return out, (0, 0)


_lk_op.register_vmap(_lk_vmap)


def track(
    prev: Pyramid,
    nxt: Pyramid,
    pts: torch.Tensor,  # (N, 2) (x, y) positions in the previous frame, level-0 scale
    valid: torch.Tensor,  # (N,) input validity mask
    settings: OpticalFlowSettings,
    init_flow: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track features from `prev` into `nxt`.

    Returns (new_pts, tracked): new (N, 2) level-0 positions and the status
    mask (input-valid & gradient-conditioned & in-bounds at every level).
    """
    flow0 = torch.zeros_like(pts) if init_flow is None else init_flow.to(pts.dtype)
    flow, good = _lk_op(list(prev.levels), list(nxt.levels), pts, flow0, settings.window_size,
                        settings.iterations, float(settings.min_eigen_threshold))
    return pts + flow, valid & good
