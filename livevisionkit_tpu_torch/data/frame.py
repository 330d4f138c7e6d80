"""Frame: the device-resident video frame value type (counterpart of
livevisionkit_tpu/data/frame.py).

A planar ``(C, H, W)`` float32 tensor in [0, 1] with a timestamp, a 0-d bool
``valid`` flag (False during a filter's warm-up delay: the reference's
"empty frame", CompositeFilter.cpp:75-80) and a pixel-format tag.  All
tensors of a frame live on one device.  Alpha planes are not carried yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.ops import color as color_ops
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass


@pytree_dataclass(static=("format",))
@dataclass(frozen=True)
class Frame:
    pixels: torch.Tensor  # (C, H, W) float32 in [0, 1] (or the u8 queue payload)
    timestamp: torch.Tensor  # 0-d float32 seconds since stream start
    valid: torch.Tensor  # 0-d bool
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
    ) -> "Frame":
        if pixels.ndim == 2:  # allow (H, W) shorthand for grayscale
            pixels = pixels[None]
            fmt = PixelFormat.GRAY
        dev = pixels.device
        return cls(
            pixels=pixels.to(torch.float32),
            timestamp=torch.as_tensor(timestamp, dtype=torch.float32, device=dev),
            valid=torch.as_tensor(valid, dtype=torch.bool, device=dev),
            format=fmt,
        )

    def replace(self, **changes) -> "Frame":
        return dataclasses.replace(self, **changes)

    def with_pixels(self, pixels: torch.Tensor, fmt: PixelFormat | None = None) -> "Frame":
        """Metadata-preserving pixel replacement (reference VideoFrame
        clone/copyTo semantics, Data/VideoFrame.cpp:78-120); shape-changing
        filters (ScalingFilter) use it.  The JAX package also resamples a
        carried alpha plane here (livevisionkit_tpu/data/frame.py:106-119);
        that waits for the port's alpha slice, since no alpha is carried."""
        return self.replace(pixels=pixels, format=self.format if fmt is None else fmt)

    def reformat(self, target: PixelFormat) -> "Frame":
        """Full colour conversion (reference ``reformatTo``,
        Data/VideoFrame.cpp:170-306), by `ops/color.convert`."""
        if target is self.format:
            return self
        return self.replace(pixels=color_ops.convert(self.pixels, self.format, target), format=target)

    def luma(self) -> torch.Tensor:
        """(H, W) luminance plane — the tracking input.  GRAY/YUV take plane
        0 directly (the reference's zero-copy viewAsFormat)."""
        return color_ops.luma(self.pixels, self.format)
