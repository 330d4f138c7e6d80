"""Colour-space conversions on planar (C, H, W) tensors (counterpart of
livevisionkit_tpu/ops/color.py).

BT.601 full-range constants, matching OpenCV's cvtColor as the reference
uses it (Data/VideoFrame.cpp:170-306): Y = 0.299R + 0.587G + 0.114B,
U = 0.492(B - Y) + 0.5, V = 0.877(R - Y) + 0.5.  Each conversion is a 3x3
matrix and an offset per pixel, applied plane by plane with Python-scalar
coefficients: a small coefficient tensor built from host values would be a
host-to-device copy, which synchronizes the stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from livevisionkit_tpu_torch.types import PixelFormat

_LUMA_R, _LUMA_G, _LUMA_B = 0.299, 0.587, 0.114
_U_SCALE, _V_SCALE = 0.492, 0.877
_CHROMA_OFFSET = 0.5


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> u8: scale, add 0.5 and truncate, clamped to [0, 255]."""
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def from_u8(x: torch.Tensor) -> torch.Tensor:
    """u8 -> [0, 1] float32."""
    return x.to(torch.float32) * (1.0 / 255.0)


@functools.cache
def rgb_to_yuv_matrix() -> tuple[tuple[tuple[float, ...], ...], tuple[float, ...]]:
    """(3x3 matrix, offset) of RGB -> YUV, float32 values as nested tuples."""
    r, g, b = _LUMA_R, _LUMA_G, _LUMA_B
    m = np.array([
        [r, g, b],
        [-_U_SCALE * r, -_U_SCALE * g, _U_SCALE * (1.0 - b)],
        [_V_SCALE * (1.0 - r), -_V_SCALE * g, -_V_SCALE * b],
    ], np.float32)
    off = np.array([0.0, _CHROMA_OFFSET, _CHROMA_OFFSET], np.float32)
    return _as_tuples(m, off)


@functools.cache
def yuv_to_rgb_matrix() -> tuple[tuple[tuple[float, ...], ...], tuple[float, ...]]:
    """(3x3 matrix, offset) of YUV -> RGB: the float32 inverse of
    `rgb_to_yuv_matrix`, as the JAX package computes it."""
    m, off = (np.array(v, np.float32) for v in rgb_to_yuv_matrix())
    inv = np.linalg.inv(m).astype(np.float32)
    return _as_tuples(inv, -inv @ off)


def _as_tuples(m: np.ndarray, off: np.ndarray):
    return tuple(tuple(float(v) for v in row) for row in m), tuple(float(v) for v in off)


def _matmul_chw(m, pixels: torch.Tensor, offset) -> torch.Tensor:
    """y_i = sum_j m[i][j] x_j + offset[i] per pixel of (3, H, W) planes."""
    x = (pixels[0], pixels[1], pixels[2])
    return torch.stack([
        row[0] * x[0] + row[1] * x[1] + row[2] * x[2] + o for row, o in zip(m, offset)
    ])


def luma_weights(fmt: PixelFormat) -> tuple[float, float, float] | None:
    """The weights of planes 0, 1 and 2 in `luma` of the format, or None
    where the luma is plane 0 itself (GRAY, YUV)."""
    if fmt in (PixelFormat.GRAY, PixelFormat.YUV):
        return None
    if fmt is PixelFormat.RGB:
        return (_LUMA_R, _LUMA_G, _LUMA_B)
    if fmt is PixelFormat.BGR:
        return (_LUMA_B, _LUMA_G, _LUMA_R)
    raise ValueError(f"cannot take luma of {fmt}")


def luma(pixels: torch.Tensor, fmt: PixelFormat) -> torch.Tensor:
    """(H, W) luminance from a (C, H, W) tensor of the given format."""
    w = luma_weights(fmt)
    if w is None:
        return pixels[0]
    return w[0] * pixels[0] + w[1] * pixels[1] + w[2] * pixels[2]


def convert(pixels: torch.Tensor, src: PixelFormat, dst: PixelFormat) -> torch.Tensor:
    """Convert (C, H, W) planes between any two of RGB, BGR, YUV and GRAY
    (the reference's conversion matrix, VideoFrame.cpp:170-306), including
    the GRAY -> YUV mid-chroma merge (Y = gray, U = V = 0.5)."""
    if src is dst:
        return pixels
    if PixelFormat.UNKNOWN in (src, dst):
        raise ValueError("cannot convert to/from UNKNOWN format")
    if src is PixelFormat.GRAY:
        g = pixels[0]
        if dst in (PixelFormat.RGB, PixelFormat.BGR):
            return torch.stack([g, g, g])
        half = torch.full_like(g, _CHROMA_OFFSET)
        return torch.stack([g, half, half])
    if dst is PixelFormat.GRAY:
        return luma(pixels, src)[None]
    if src is PixelFormat.BGR:
        return convert(pixels.flip(0), PixelFormat.RGB, dst)
    if dst is PixelFormat.BGR:
        return convert(pixels, src, PixelFormat.RGB).flip(0)
    if src is PixelFormat.RGB and dst is PixelFormat.YUV:
        m, off = rgb_to_yuv_matrix()
        return _matmul_chw(m, pixels, off)
    if src is PixelFormat.YUV and dst is PixelFormat.RGB:
        m, off = yuv_to_rgb_matrix()
        return _matmul_chw(m, pixels, off)
    raise ValueError(f"unsupported conversion {src} -> {dst}")
