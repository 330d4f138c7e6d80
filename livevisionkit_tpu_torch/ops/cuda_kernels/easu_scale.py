"""Launch wrapper of the EASU scale kernel (csrc/easu_scale.cu).

Replaces livevisionkit_tpu/ops/tpu_kernels/easu_scale.py::pallas_easu_up
(the fused p-times upscale) and, since it takes every ratio, the XLA
rational and fallback paths of livevisionkit_tpu/ops/easu.easu_scale.  Its
plain version is ops/easu.easu_scale_plain, which it matches borders
included.

What bounds it on the H100: arithmetic.  At 1080p -> 4K f32 it reads
~25 MB and writes ~100 MB (~37 us at 3.35 TB/s) but does ~430 f32
operations for each of 8.3 M outputs and 27 for each of the 2.1 M source
pixels' direction terms (~54 us at 67 TFLOP/s).  At 2x every
source quad is the f of four outputs, which a thread per output repeated:
its gathers, luma and direction terms.  Its design (csrc/easu_scale.cu,
csrc/easu.cuh): a block owns a 64 x 32 output tile, places its columns and
rows once (no (2, OH, OW) map, which at 4K would be 66 MB), stages the
tile's source box in shared memory with each source pixel's direction
terms computed once, and resolves every output from there; a tile whose
box exceeds the kernel's capacity (a strong downscale) gathers from device
memory.  One kernel per channel count, so no dead channel is carried.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.types import PixelFormat

_MAX_CHANNELS = 4


def easu_scale(
    img: torch.Tensor, out_size: tuple[int, int], plan, fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """EASU-resize a contiguous f32 CUDA (C, H, W) or (H, W) image to
    `out_size`, placing samples by `plan` (an ops/easu.ScalePlan: the exact
    rational form, or the f32 fallback); returns (C, OH, OW) f32."""
    if img.dtype != torch.float32:
        raise TypeError(f"easu_scale kernel takes f32 images, got {img.dtype}")
    if not img.is_cuda:
        raise ValueError("easu_scale kernel needs a CUDA tensor")
    squeeze = img.ndim == 2
    img3 = img[None] if squeeze else img
    if img3.ndim != 3 or not 1 <= img3.shape[0] <= _MAX_CHANNELS:
        raise ValueError(f"easu_scale kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if not img3.is_contiguous():
        raise ValueError("easu_scale kernel needs a contiguous image")
    c, h, w = img3.shape
    oh, ow = out_size
    if min(h, w, oh, ow) < 1:
        raise ValueError(f"empty easu_scale: {(h, w)} -> {(oh, ow)}")
    rgb_luma = fmt not in (PixelFormat.YUV, PixelFormat.GRAY)
    if rgb_luma and c < 3:
        raise ValueError(f"EASU luma of {fmt} needs 3 channels, got {c}")
    out = torch.empty((c, oh, ow), dtype=torch.float32, device=img3.device)
    status = build.library().lvk_easu_scale(
        img3.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
        int(plan.rational), plan.py, plan.qy, plan.px, plan.qx, h / oh, w / ow, int(rgb_luma),
        torch.cuda.current_stream(img3.device).cuda_stream,
    )
    build.check(status, "easu_scale")
    easu_scale.launches += 1
    return out[0] if squeeze else out


easu_scale.launches = 0
