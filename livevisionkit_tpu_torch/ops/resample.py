"""Resize, pyramid and gradient ops on (..., H, W) tensors (counterpart of
livevisionkit_tpu/ops/resample.py; the stabilizer's path needs `resize` with
antialias and the pyrDown pyramid, mesh mode the corner-aligned resize of
its warp fields, the deblocker block means, a median and integer
upsamples).

Reference parity: the detection-resolution downscale (FrameTracker.cpp:117),
cv::buildOpticalFlowPyramid's pyrDown (5-tap binomial blur + 2x
decimation, BORDER_REFLECT_101), OpenCV LK's Scharr 3x3 derivative, and
the corner-aligned grid interpolation of WarpField meshes
(Math/VirtualGrid.cpp:85-117).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.ops.cuda_kernels import deblock as deblock_kernel

# 5-tap binomial (Gaussian approx) used by cv::pyrDown.
_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# Scharr 3x3 derivative, OpenCV normalisation (1/32).
_SCHARR_D = (-1.0, 0.0, 1.0)
_SCHARR_S = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)


def _sep_conv2d(img: torch.Tensor, kh, kw) -> torch.Tensor:
    """Separable 2-D correlation with reflect-101 padding, as tap-weighted
    shifted slices summed in the same order as the JAX version."""
    ph, pw = len(kh) // 2, len(kw) // 2
    h, w = img.shape[-2], img.shape[-1]
    lead = img.shape[:-2]
    x = F.pad(img.reshape((1, -1, h, w)), (pw, pw, ph, ph), mode="reflect")
    x = x.reshape(lead + x.shape[-2:])
    acc = None
    for i, kv in enumerate(kh):  # H pass (keeps W padding)
        term = x[..., i : i + h, :] * kv
        acc = term if acc is None else acc + term
    out = None
    for j, kv in enumerate(kw):  # W pass
        term = acc[..., :, j : j + w] * kv
        out = term if out is None else out + term
    return out


def gaussian_blur5(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (cv::pyrDown's smoothing kernel)."""
    return _sep_conv2d(img, _BINOMIAL5, _BINOMIAL5)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level: binomial blur + 2x decimation; output ceil(n/2)."""
    return gaussian_blur5(img)[..., ::2, ::2].contiguous()


def scharr_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) Scharr 3x3 gradients with OpenCV's 1/32 scaling."""
    return _sep_conv2d(img, _SCHARR_S, _SCHARR_D), _sep_conv2d(img, _SCHARR_D, _SCHARR_S)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Image pyramid [level0=img, level1=half, ...], `levels` entries total."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


@functools.cache
def _weight_mat(
    in_size: int, out_size: int, antialias: bool, device: torch.device
) -> torch.Tensor:
    """(in, out) linear-resize weights, built exactly as
    `jax.image.scale_and_translate` builds them (translation 0): a triangle
    kernel widened by the downscale ratio when antialiasing, normalised per
    output sample, zeroed where the sample centre leaves the input.

    The ratio is formed in double precision and rounded to float32 where it
    meets a float32 array, as in JAX; the y ratio 1080 -> 272 is not an
    integer, so `F.interpolate(antialias=True)` does not give these edge
    weights.  Cached per (sizes, mode, device): the weights depend on shapes only.
    Never evicted: a captured CUDA graph (utils/compiled.py) reads them
    where they lie.
    """
    inv_scale = 1.0 / (out_size / in_size)
    inv = torch.tensor(inv_scale, dtype=torch.float32)
    kernel_scale = torch.maximum(inv, torch.tensor(1.0)) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(
        total.abs() > 1000.0 * eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def resize(img: torch.Tensor, size: tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """Linear resize of (..., H, W) to (..., size[0], size[1]), equal to
    `jax.image.resize(method="linear")`; with antialias the downscale
    behaves like INTER_AREA.  Two float32 matrix products with the separable
    weight matrices (W first, then H)."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = size
    out = img
    if ow != w:
        out = out @ _weight_mat(w, ow, antialias, img.device)
    if oh != h:
        out = _weight_mat(h, oh, antialias, img.device).transpose(0, 1) @ out
    return out


def resize_corner_aligned(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with CORNER alignment: output pixel i
    samples input coordinate i*(in-1)/(out-1), so the corner pixels map onto
    each other exactly (align_corners=True).  This is the interpolation of
    WarpField grids, whose control points are corner-aligned over the frame.
    One `F.interpolate` call; it keeps the input's device and, under
    `torch.func.vmap`, its stream axis."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = size
    if (in_h, in_w) == (out_h, out_w):
        return img
    if in_h == 1 or in_w == 1:
        raise ValueError("corner-aligned resize needs >= 2 samples per axis")
    lead = img.shape[:-2]
    x = img.reshape((1, -1, in_h, in_w))
    out = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
    return out.reshape(lead + (out_h, out_w))


def upsample_nearest_int(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Replicate each pixel of trailing (H, W) into a factor x factor block."""
    *lead, h, w = img.shape
    x = img[..., :, None, :, None].expand(*lead, h, factor, w, factor)
    return x.reshape(*lead, h * factor, w * factor)


def upsample_linear_int(img: torch.Tensor, factor: tuple[int, int]) -> torch.Tensor:
    """Integer-factor bilinear upsample of trailing (H, W), half-pixel
    centres and edge clamping: `jax.image.resize(..., "linear",
    antialias=False)`, which `F.interpolate(align_corners=False)` computes.
    (The JAX package's polyphase slices are a TPU lowering, not ported.)"""
    fy, fx = factor
    h, w = img.shape[-2], img.shape[-1]
    lead = img.shape[:-2]
    x = img.reshape((1, -1, h, w))
    out = F.interpolate(x, size=(h * fy, w * fx), mode="bilinear", align_corners=False)
    return out.reshape(lead + (h * fy, w * fx))


def median_blur_plain(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """`median_blur` as plain PyTorch ops on any device: the exact median
    of the ksize^2 reflect-101 shifted views, so it equals the JAX
    package's selection network bit for bit.  (That network exists because
    XLA sorts serially on a TPU.)  The CPU path, and the reference the
    median kernel is held against on the card."""
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    lead = img.shape[:-2]
    x = F.pad(img.reshape((1, -1, h, w)), (r, r, r, r), mode="reflect")
    x = x.reshape(lead + x.shape[-2:])
    patches = torch.stack([x[..., dy:dy + h, dx:dx + w]
                           for dy in range(ksize) for dx in range(ksize)])
    return torch.median(patches, dim=0).values


def median_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize median filter of trailing (H, W) (cv::medianBlur),
    reflect-101 padded.  The custom op ``lvk::median_blur``: a CUDA tensor
    launches the median kernel (ops/cuda_kernels/deblock.median_blur, K8;
    f32, ksize 3, 5 or 7, else a ValueError), a CPU tensor takes
    `median_blur_plain`; the two are equal bit for bit.  Under
    `torch.func.vmap` the stream axis is one more leading axis of planes."""
    return _median_op(img, int(ksize))


@torch.library.custom_op("lvk::median_blur", mutates_args=(),
                         schema="(Tensor img, int ksize) -> Tensor")
def _median_op(img, ksize):
    """The median kernel for a CUDA tensor, `median_blur_plain` for a CPU
    one."""
    if img.is_cuda:
        return deblock_kernel.median_blur(img.contiguous(), ksize)
    return median_blur_plain(img, ksize)


@_median_op.register_fake
def _median_fake(img, ksize):
    return img.new_empty(img.shape)


def _median_vmap(info, in_dims, img, ksize):
    """vmap rule of ``lvk::median_blur``: planes are filtered one by one,
    so the stream axis is one more leading axis of the same call."""
    return _median_op(img.movedim(in_dims[0], 0), ksize), 0


_median_op.register_vmap(_median_vmap)


def avg_pool(img: torch.Tensor, block: int) -> torch.Tensor:
    """Non-overlapping block mean over trailing (H, W); H, W must divide."""
    *lead, h, w = img.shape
    x = img.reshape(*lead, h // block, block, w // block, block)
    return x.mean(dim=(-3, -1))
