"""Launch wrappers of the CAS kernel (csrc/cas.cu, K9): `cas` for one frame
and `cas_batched` for a stack of S streams, one launch each.

Replaces no TPU kernel: the JAX package leaves ops/cas.py to XLA, which
fuses it into one pass.  Its plain version is ops/cas.cas_plain (under
torch.func.vmap for the batch), ~35 elementwise passes over the frame
and strided views of its edge pad, which it matches bit for bit.

What bounds it on the H100: bytes.  At 3x2160x3840 f32 the frame is
read once and written once, ~199 MB, 0.059 ms at 3.35 TB/s; its ~35 f32
operations a channel and pixel (two IEEE divisions and a square root
among them) are ~0.013 ms at 67 TFLOP/s.  Its design (csrc/cas.cu), K6's:
a register-blocked vector stencil.  A thread owns 4 adjacent pixels of a
row in every channel and walks a few rows down that strip with the rows
above, at and below in registers; rows move as 16-byte loads and
streaming stores (4 scalar ones where the width is not a multiple of 4),
the side neighbours and diagonals come by warp shuffle.  The border is
filtered against the edge-replicated neighbourhood by clamping the row
and column it reads, so no padded copy is made.  S streams are S
z-slices of one grid; a frame that every stream shares is read at
stream stride 0, never copied.  `peak` is ops/cas.cas_peak(sharpness).
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_CHANNELS = 4
_MAX_STREAMS = 65535


def _launch(imgs, out, n_streams, src_ss, c, peak) -> None:
    """Checks shared by both wrappers, then one launch: `n_streams` f32
    frames of `c` (H, W) planes, src_ss elements apart, into the contiguous
    `out`."""
    if imgs.dtype != torch.float32:
        raise TypeError(f"cas kernel takes f32 images, got {imgs.dtype}")
    if not imgs.is_cuda:
        raise ValueError("cas kernel needs a CUDA tensor")
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"cas kernel takes 1..{_MAX_CHANNELS} channels, got {c}")
    h, w = imgs.shape[-2:]
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(imgs.device):
        status = build.library().lvk_cas_batched(
            imgs.data_ptr(), out.data_ptr(), n_streams, src_ss, c, h, w, float(peak),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    build.check(status, "cas")


def cas(img: torch.Tensor, peak: float) -> torch.Tensor:
    """Sharpen a contiguous f32 CUDA (C, H, W) or (H, W) image; returns a
    new tensor of the same shape.  The kernel's S = 1 launch."""
    if img.ndim not in (2, 3):
        raise ValueError(f"cas kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("cas kernel needs a contiguous image")
    out = torch.empty_like(img, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    _launch(img, out, 1, 0, 1 if img.ndim == 2 else img.shape[0], peak)
    cas.launches += 1
    return out


def cas_batched(imgs: torch.Tensor, peak: float) -> torch.Tensor:
    """Sharpen S f32 CUDA frames, (S, C, H, W) or (S, H, W), in one launch;
    returns a new contiguous tensor of the same shape.  Each stream's frame
    must be contiguous; a frame broadcast over streams (stream stride 0) is
    read in place."""
    if imgs.ndim not in (3, 4):
        raise ValueError(f"cas_batched takes (S, C, H, W) frames, got {tuple(imgs.shape)}")
    n = imgs.shape[0]
    if not 1 <= n <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, got {n}")
    if not blocks_contiguous(imgs):
        raise ValueError("cas kernel needs each stream's frame contiguous")
    out = torch.empty(imgs.shape, dtype=imgs.dtype, device=imgs.device)
    if out.numel() == 0:
        return out
    _launch(imgs, out, n, imgs.stride(0), 1 if imgs.ndim == 3 else imgs.shape[1], peak)
    cas_batched.launches += 1
    return out


cas.launches = 0
cas_batched.launches = 0
