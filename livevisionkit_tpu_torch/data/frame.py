"""Frame: the device-resident video frame value type (counterpart of
livevisionkit_tpu/data/frame.py).

A planar ``(C, H, W)`` float32 tensor in [0, 1] with a timestamp, a 0-d bool
``valid`` flag (False during a filter's warm-up delay: the reference's
"empty frame", CompositeFilter.cpp:75-80), a pixel-format tag and an
optional full-resolution ``alpha`` plane (H, W) in [0, 1].  All tensors of
a frame live on one device.  The reference uploads only the colour planes
and leaves alpha in the OBS frame; here, as in the JAX package, alpha rides
the frame: colour conversion never touches it, shape-changing filters
resample it (`with_pixels`) and the stabilizer warps it together with the
colour planes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.ops import color as color_ops
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass


@pytree_dataclass(static=("format",))
@dataclass(frozen=True)
class Frame:
    pixels: torch.Tensor  # (C, H, W) float32 in [0, 1] (or the u8 queue payload)
    timestamp: torch.Tensor  # 0-d float32 seconds since stream start
    valid: torch.Tensor  # 0-d bool
    alpha: torch.Tensor | None = None  # (H, W) float32 in [0, 1], or None (opaque)
    format: PixelFormat = PixelFormat.UNKNOWN

    @property
    def height(self) -> int:
        return self.pixels.shape[-2]

    @property
    def width(self) -> int:
        return self.pixels.shape[-1]

    @property
    def channels(self) -> int:
        return self.pixels.shape[-3]

    @property
    def size(self) -> tuple[int, int]:
        """(height, width)."""
        return (self.height, self.width)

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    @classmethod
    def create(
        cls,
        pixels: torch.Tensor,
        timestamp: float | torch.Tensor = 0.0,
        fmt: PixelFormat = PixelFormat.RGB,
        valid: bool | torch.Tensor = True,
        alpha: torch.Tensor | None = None,
    ) -> "Frame":
        if pixels.ndim == 2:  # allow (H, W) shorthand for grayscale
            pixels = pixels[None]
            fmt = PixelFormat.GRAY
        dev = pixels.device
        return cls(
            pixels=pixels.to(torch.float32),
            timestamp=torch.as_tensor(timestamp, dtype=torch.float32, device=dev),
            valid=torch.as_tensor(valid, dtype=torch.bool, device=dev),
            alpha=None if alpha is None else alpha.to(torch.float32),
            format=fmt,
        )

    def replace(self, **changes) -> "Frame":
        return dataclasses.replace(self, **changes)

    def with_pixels(self, pixels: torch.Tensor, fmt: PixelFormat | None = None) -> "Frame":
        """Metadata-preserving pixel replacement (reference VideoFrame
        clone/copyTo semantics, Data/VideoFrame.cpp:78-120).  A carried
        alpha plane follows a change of size by a bilinear resample, so
        shape-changing filters (ScalingFilter) keep it without a case of
        their own."""
        alpha = self.alpha
        if alpha is not None and tuple(pixels.shape[-2:]) != tuple(alpha.shape):
            alpha = resample.resize(alpha, tuple(pixels.shape[-2:]), antialias=False)
        return self.replace(pixels=pixels, alpha=alpha, format=self.format if fmt is None else fmt)

    def reformat(self, target: PixelFormat) -> "Frame":
        """Full colour conversion (reference ``reformatTo``,
        Data/VideoFrame.cpp:170-306), by `ops/color.convert`; alpha is
        left as it is."""
        if target is self.format:
            return self
        return self.replace(pixels=color_ops.convert(self.pixels, self.format, target), format=target)

    def luma(self) -> torch.Tensor:
        """(H, W) luminance plane — the tracking input.  GRAY/YUV take plane
        0 directly (the reference's zero-copy viewAsFormat)."""
        return color_ops.luma(self.pixels, self.format)
