"""Launch wrapper of the EASU / bilinear warp kernel (csrc/warp.cu).

Replaces livevisionkit_tpu/ops/tpu_kernels/warp.py::pallas_remap (bodies
``_easu_kernel`` and ``_kernel``).  Its plain version is ops/remap.remap_plain
(ops/easu.easu_remap and ops/remap.bilinear_sample), which it matches
borders included.

What bounds it on the H100: per output pixel it reads an 8-byte sample-map
entry, gathers 12 taps x C channels (4 for bilinear) from a source that
stays in L2 across neighbouring pixels, and writes C outputs; for a 1080p
u8 YUV frame that is about 16 MB of map, 6 MB of frame and 6 MB of output,
so it is bound by memory traffic and gather latency rather than arithmetic.
Its design: one thread per output pixel, taps through the read-only cache,
all channels of a pixel in one thread so the direction and kernel shape are
computed once, and u8 kept u8 in memory (converted in registers).
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.types import PixelFormat

_MAX_CHANNELS = 4


def warp(
    img: torch.Tensor,
    sample_map: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "easu",
    fmt: PixelFormat = PixelFormat.YUV,
) -> torch.Tensor:
    """Warp a CUDA (C, H, W) or (H, W) u8/f32 image by a (2, H', W') f32
    absolute (y, x) map; returns (C, H', W') of the image's dtype.  `fill`
    is a scalar on the image's own scale (0..255 for u8), or None for
    replicate borders."""
    if not (img.is_cuda and sample_map.is_cuda) or img.device != sample_map.device:
        raise ValueError("warp kernel needs the image and the map on one CUDA device")
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"warp kernel takes u8 or f32 images, got {img.dtype}")
    if sample_map.dtype != torch.float32:
        raise TypeError(f"sample map must be f32, got {sample_map.dtype}")
    if filter_mode not in ("easu", "bilinear"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    squeeze = img.ndim == 2
    img3 = img[None] if squeeze else img
    if img3.ndim != 3 or not 1 <= img3.shape[0] <= _MAX_CHANNELS:
        raise ValueError(f"warp kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if sample_map.ndim != 3 or sample_map.shape[0] != 2:
        raise ValueError(f"sample map must be (2, H, W), got {tuple(sample_map.shape)}")
    if not (img3.is_contiguous() and sample_map.is_contiguous()):
        raise ValueError("warp kernel needs contiguous image and map")
    c, h, w = img3.shape
    oh, ow = sample_map.shape[1:]
    rgb_luma = filter_mode == "easu" and fmt not in (PixelFormat.YUV, PixelFormat.GRAY)
    if rgb_luma and c < 3:
        raise ValueError(f"EASU luma of {fmt} needs 3 channels, got {c}")
    out = torch.empty((c, oh, ow), dtype=img3.dtype, device=img3.device)
    lib = build.library()
    status = lib.lvk_warp(
        img3.data_ptr(), sample_map.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
        int(img3.dtype == torch.uint8), int(filter_mode == "easu"),
        int(fill is not None), 0.0 if fill is None else float(fill), int(rgb_luma),
        torch.cuda.current_stream(img3.device).cuda_stream,
    )
    build.check(status, "warp")
    warp.launches += 1
    return out[0] if squeeze else out


warp.launches = 0
