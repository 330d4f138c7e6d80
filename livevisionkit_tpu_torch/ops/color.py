"""Colour ops on planar (C, H, W) tensors (counterpart of
livevisionkit_tpu/ops/color.py; only `luma` is on the stabilizer's path).

BT.601 full-range luma weights, matching OpenCV's cvtColor constants used by
the reference (Data/VideoFrame.cpp:170-306).
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.types import PixelFormat

_LUMA_R, _LUMA_G, _LUMA_B = 0.299, 0.587, 0.114


def luma(pixels: torch.Tensor, fmt: PixelFormat) -> torch.Tensor:
    """(H, W) luminance from a (C, H, W) tensor of the given format."""
    if fmt in (PixelFormat.GRAY, PixelFormat.YUV):
        return pixels[0]
    if fmt is PixelFormat.RGB:
        w = (_LUMA_R, _LUMA_G, _LUMA_B)
    elif fmt is PixelFormat.BGR:
        w = (_LUMA_B, _LUMA_G, _LUMA_R)
    else:
        raise ValueError(f"cannot take luma of {fmt}")
    return w[0] * pixels[0] + w[1] * pixels[1] + w[2] * pixels[2]
