"""Launch wrapper of the RCAS kernel (csrc/rcas.cu).

Replaces livevisionkit_tpu/ops/tpu_kernels/rcas.py::pallas_rcas.  Its plain
version is ops/rcas.rcas_plain, which it matches operation for operation.

What bounds it on the H100: a 5-tap cross per pixel and channel with two
divisions, a reciprocal and ~30 other FLOPs; at 3x2160x3840 f32 that is
~100 MB read and ~100 MB written, ~60 us at 3.35 TB/s, so memory traffic
bounds it.  Its design (csrc/rcas.cu): a register-blocked vector stencil.
A thread owns 4 adjacent pixels of a row in every channel and walks 2
rows down that strip with the rows above, at and below in registers;
rows move as 16-byte loads and streaming stores (4 scalar ones where the
width is not a multiple of 4), the side neighbours come by warp shuffle.
Behind the bytes, the issue of its IEEE divisions holds it.  The lobe is
reduced across channels in registers, so no (1, H, W) lobe plane ever
reaches device memory; border pixels are copied in the same pass.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build

_MAX_CHANNELS = 4


def rcas(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen a contiguous f32 CUDA (C, H, W) or (H, W) image; returns a
    new tensor of the same shape."""
    if img.dtype != torch.float32:
        raise TypeError(f"rcas kernel takes f32 images, got {img.dtype}")
    if not img.is_cuda:
        raise ValueError("rcas kernel needs a CUDA tensor")
    squeeze = img.ndim == 2
    img3 = img[None] if squeeze else img
    if img3.ndim != 3 or not 1 <= img3.shape[0] <= _MAX_CHANNELS:
        raise ValueError(f"rcas kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if not img3.is_contiguous():
        raise ValueError("rcas kernel needs a contiguous image")
    c, h, w = img3.shape
    out = torch.empty_like(img3)
    if out.numel() == 0:
        return out[0] if squeeze else out
    status = build.library().lvk_rcas(
        img3.data_ptr(), out.data_ptr(), c, h, w, float(sharpness),
        torch.cuda.current_stream(img3.device).cuda_stream,
    )
    build.check(status, "rcas")
    rcas.launches += 1
    return out[0] if squeeze else out


rcas.launches = 0
