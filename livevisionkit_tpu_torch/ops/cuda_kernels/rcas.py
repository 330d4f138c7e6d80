"""Launch wrappers of the RCAS kernel (csrc/rcas.cu): `rcas` for one frame
and `rcas_batched` for a stack of S streams, one launch each.

Replaces livevisionkit_tpu/ops/tpu_kernels/rcas.py::pallas_rcas.  Its plain
version is ops/rcas.rcas_plain (under torch.func.vmap for the batch),
which it matches operation for operation.

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
reaches device memory; border pixels are copied in the same pass.  S
streams are S z-slices of one grid; a frame that every stream shares is
read at stream stride 0, never copied.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_CHANNELS = 4
_MAX_STREAMS = 65535


def _launch(imgs, out, n_streams, src_ss, c, sharpness) -> None:
    """Checks shared by both wrappers, then one launch: `n_streams` f32
    frames of `c` (H, W) planes, src_ss elements apart, into the contiguous
    `out`."""
    if imgs.dtype != torch.float32:
        raise TypeError(f"rcas kernel takes f32 images, got {imgs.dtype}")
    if not imgs.is_cuda:
        raise ValueError("rcas kernel needs a CUDA tensor")
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"rcas kernel takes 1..{_MAX_CHANNELS} channels, got {c}")
    h, w = imgs.shape[-2:]
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(imgs.device):
        status = build.library().lvk_rcas_batched(
            imgs.data_ptr(), out.data_ptr(), n_streams, src_ss, c, h, w, float(sharpness),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    build.check(status, "rcas")


def rcas(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen a contiguous f32 CUDA (C, H, W) or (H, W) image; returns a
    new tensor of the same shape.  The kernel's S = 1 launch."""
    if img.ndim not in (2, 3):
        raise ValueError(f"rcas kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("rcas kernel needs a contiguous image")
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    _launch(img, out, 1, 0, 1 if img.ndim == 2 else img.shape[0], sharpness)
    rcas.launches += 1
    return out


def rcas_batched(imgs: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen S f32 CUDA frames, (S, C, H, W) or (S, H, W), in one launch;
    returns a new contiguous tensor of the same shape.  Each stream's frame
    must be contiguous; a frame broadcast over streams (stream stride 0) is
    read in place."""
    if imgs.ndim not in (3, 4):
        raise ValueError(f"rcas_batched takes (S, C, H, W) frames, got {tuple(imgs.shape)}")
    n = imgs.shape[0]
    if not 1 <= n <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, got {n}")
    if not blocks_contiguous(imgs):
        raise ValueError("rcas kernel needs each stream's frame contiguous")
    out = torch.empty(imgs.shape, dtype=imgs.dtype, device=imgs.device)
    if out.numel() == 0:
        return out
    _launch(imgs, out, n, imgs.stride(0), 1 if imgs.ndim == 3 else imgs.shape[1], sharpness)
    rcas_batched.launches += 1
    return out


rcas.launches = 0
rcas_batched.launches = 0
