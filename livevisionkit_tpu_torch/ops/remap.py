"""Warp-resampling (remap): the hot path of the engine (counterpart of
livevisionkit_tpu/ops/remap.py).

Conventions shared with the JAX package:

  * sample maps are absolute pixel coordinates stacked as (2, H', W') with
    plane 0 = y, plane 1 = x (pixel centres at integer coordinates);
  * a backward warp: output(u) = input(map(u)); the map sets the output size.

One dispatch rule: a CUDA tensor goes to the hand-written warp kernel
(ops/cuda_kernels/warp.py), a CPU tensor to the plain ops below, which are
also the kernel's reference.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops import easu as easu_ops
from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
from livevisionkit_tpu_torch.types import PixelFormat


def bilinear_sample(
    img: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    fill: float | None = None,
) -> torch.Tensor:
    """Sample (..., H, W) image planes at fractional (ys, xs) of equal shape
    S; returns (..., *S).  fill=None clamps to the border (replicate);
    otherwise out-of-bounds samples take the scalar `fill`."""
    h, w = img.shape[-2], img.shape[-1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0).to(img.dtype)
    wx = (xs - x0).to(img.dtype)

    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)

    v00 = img[..., y0i, x0i]
    v01 = img[..., y0i, x1i]
    v10 = img[..., y1i, x0i]
    v11 = img[..., y1i, x1i]

    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy

    if fill is not None:
        inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
        out = torch.where(inside, out, float(fill))
    return out


def remap(
    img: torch.Tensor,
    sample_map: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "bilinear",
    fmt: PixelFormat | None = None,
) -> torch.Tensor:
    """Backward-warp a (C, H, W) or (H, W) image, u8 or float32, by an
    absolute-coordinate (2, H', W') map (reference lvk::remap,
    Functions/Image.cpp:28-81).

    filter_mode "easu" is the reference-parity filter (every corrective warp
    there goes through the fused EASU kernel); "bilinear" is cheaper.  `fmt`
    selects EASU's luma (default YUV).  A u8 image is filtered on its
    0..255 scale and rounded half to even back to u8.
    """
    if filter_mode not in ("bilinear", "easu"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if fmt is None:
        fmt = PixelFormat.YUV
    if img.is_cuda:
        return warp_kernel.warp(img, sample_map, fill=fill, filter_mode=filter_mode, fmt=fmt)
    return remap_plain(img, sample_map, fill=fill, filter_mode=filter_mode, fmt=fmt)


def remap_plain(
    img: torch.Tensor,
    sample_map: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "bilinear",
    fmt: PixelFormat = PixelFormat.YUV,
) -> torch.Tensor:
    """`remap` as plain PyTorch ops on any device: the CPU path, and the
    reference the warp kernel is held against on the card."""
    img_f = img.to(torch.float32) if img.dtype == torch.uint8 else img
    if filter_mode == "easu":
        out = easu_ops.easu_remap(img_f, sample_map, fmt=fmt, fill=fill)
    else:
        out = bilinear_sample(img_f, sample_map[0], sample_map[1], fill=fill)
    return _cast_like(out, img.dtype)


def _cast_like(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Back to the input dtype; u8 rounds half to even, then clips."""
    if dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
    return out.to(dtype)


def identity_map(
    size: tuple[int, int], dtype=torch.float32, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """(2, H, W) map of each pixel's own coordinates."""
    h, w = size
    yy = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return torch.stack([yy, xx])
