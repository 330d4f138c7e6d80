"""Warp-resampling (remap): the hot path of the engine (counterpart of
livevisionkit_tpu/ops/remap.py).

Conventions shared with the JAX package:

  * sample maps are absolute pixel coordinates stacked as (2, H', W') with
    plane 0 = y, plane 1 = x (pixel centres at integer coordinates);
  * a backward warp: output(u) = input(map(u)); the map sets the output size.

One dispatch rule: a CUDA tensor goes to the hand-written warp kernel
(ops/cuda_kernels/warp.py), a CPU tensor to the plain ops below, which are
also the kernel's reference.  `remap` is the custom op ``lvk::remap``, whose
vmap rule (the counterpart of the JAX package's `custom_vmap` on the Pallas
core, livevisionkit_tpu/ops/remap.py:177-242) turns `torch.func.vmap` over
streams into ONE call of ``lvk::remap_batched``: one launch of the kernel
over all S streams on the card, one call of the plain ops on the stacked
tensors on the CPU, and never a loop over streams.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops import easu as easu_ops
from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import stream_first

_SCHEMA = "(Tensor img, Tensor sample_map, float? fill, str filter_mode, str fmt) -> Tensor"


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
    return _remap_op(img, sample_map, None if fill is None else float(fill), filter_mode, fmt.value)


@torch.library.custom_op("lvk::remap", mutates_args=(), schema=_SCHEMA)
def _remap_op(img, sample_map, fill, filter_mode, fmt):
    """One frame: the warp kernel for a CUDA tensor, the plain ops for a
    CPU one."""
    if img.is_cuda:
        return warp_kernel.warp(img, sample_map, fill=fill, filter_mode=filter_mode,
                                fmt=PixelFormat(fmt))
    return remap_plain(img, sample_map, fill=fill, filter_mode=filter_mode, fmt=PixelFormat(fmt))


@torch.library.custom_op("lvk::remap_batched", mutates_args=(), schema=_SCHEMA)
def _remap_batched_op(img, sample_map, fill, filter_mode, fmt):
    """S frames (S, C, H, W) or (S, H, W) by S maps (S, 2, H', W'): one
    launch of the warp kernel for CUDA tensors, the plain ops on the stack
    for CPU ones."""
    if img.is_cuda:
        return warp_kernel.warp_batched(img, sample_map, fill=fill, filter_mode=filter_mode,
                                        fmt=PixelFormat(fmt))
    return remap_batched_plain(img, sample_map, fill=fill, filter_mode=filter_mode,
                               fmt=PixelFormat(fmt))


@_remap_op.register_fake
@_remap_batched_op.register_fake
def _remap_fake(img, sample_map, fill, filter_mode, fmt):
    return img.new_empty(img.shape[:-2] + sample_map.shape[-2:])


def _remap_vmap(info, in_dims, img, sample_map, fill, filter_mode, fmt):
    """vmap rule of ``lvk::remap``: one batched warp for all streams.  An
    operand that is not batched (a map shared by every stream) is broadcast
    at stream stride 0, not copied (the JAX rule broadcasts it too)."""
    imgs = stream_first(img, in_dims[0], info.batch_size)
    maps = stream_first(sample_map, in_dims[1], info.batch_size)
    return _remap_batched_op(imgs, maps, fill, filter_mode, fmt), 0


_remap_op.register_vmap(_remap_vmap)


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


def remap_batched_plain(
    imgs: torch.Tensor,
    sample_maps: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "bilinear",
    fmt: PixelFormat = PixelFormat.YUV,
) -> torch.Tensor:
    """`remap_plain` over a leading stream axis, by torch.func.vmap: the
    batched rule's CPU path, and the reference the batched warp kernel is
    held against on the card."""
    return torch.func.vmap(
        lambda im, sm: remap_plain(im, sm, fill=fill, filter_mode=filter_mode, fmt=fmt)
    )(imgs, sample_maps)


def _cast_like(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Back to the input dtype; u8 rounds half to even, then clips."""
    if dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
    return out.to(dtype)


def identity_map(
    size: tuple[int, int], dtype=torch.float32, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """(2, H, W) map of each pixel's own coordinates."""
    h, w = size
    yy = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return torch.stack([yy, xx])
