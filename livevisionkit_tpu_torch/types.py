"""Shared leaf types (no torch imports).

Kept dependency-free so `data/`, `ops/`, and `filters/` can all import them
without cycles.
"""

from __future__ import annotations

import enum


class PixelFormat(enum.Enum):
    """Colour format tag. Mirrors lvk::VideoFrame::Format
    (reference Data/VideoFrame.hpp:27-31) minus the BGRA/RGBA alpha variants."""

    RGB = "rgb"
    BGR = "bgr"
    YUV = "yuv"
    GRAY = "gray"
    UNKNOWN = "unknown"

    @property
    def channels(self) -> int:
        return 1 if self is PixelFormat.GRAY else 3
