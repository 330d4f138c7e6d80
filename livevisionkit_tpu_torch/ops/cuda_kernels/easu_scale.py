"""Launch wrappers of the EASU scale kernel (csrc/easu_scale.cu):
`easu_scale` for one frame and `easu_scale_batched` for a stack of S
streams, one launch each.

Replaces livevisionkit_tpu/ops/tpu_kernels/easu_scale.py::pallas_easu_up
(the fused p-times upscale) and, since it takes every ratio, the XLA
rational and fallback paths of livevisionkit_tpu/ops/easu.easu_scale.  Its
plain version is ops/easu.easu_scale_plain (under torch.func.vmap for the
batch), which it matches borders included.

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
S streams are S z-slices of one grid, sharing one placement; a source
that every stream shares (broadcast under vmap) is read at stream stride
0, never copied.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_CHANNELS = 4
_MAX_STREAMS = 65535


def _launch(imgs, out, n_streams, src_ss, c, out_size, plan, fmt) -> None:
    """Checks shared by both wrappers, then one launch: `n_streams` f32
    frames of `c` (H, W) planes, src_ss elements apart, into the contiguous
    `out`."""
    if imgs.dtype != torch.float32:
        raise TypeError(f"easu_scale kernel takes f32 images, got {imgs.dtype}")
    if not imgs.is_cuda:
        raise ValueError("easu_scale kernel needs a CUDA tensor")
    h, w = imgs.shape[-2:]
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"easu_scale kernel takes 1..{_MAX_CHANNELS} channels, got {c}")
    oh, ow = out_size
    if min(h, w, oh, ow) < 1:
        raise ValueError(f"empty easu_scale: {(h, w)} -> {(oh, ow)}")
    rgb_luma = fmt not in (PixelFormat.YUV, PixelFormat.GRAY)
    if rgb_luma and c < 3:
        raise ValueError(f"EASU luma of {fmt} needs 3 channels, got {c}")
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(imgs.device):
        status = build.library().lvk_easu_scale_batched(
            imgs.data_ptr(), out.data_ptr(), n_streams, src_ss, c, h, w, oh, ow,
            int(plan.rational), plan.py, plan.qy, plan.px, plan.qx, h / oh, w / ow, int(rgb_luma),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    build.check(status, "easu_scale")


def easu_scale(
    img: torch.Tensor, out_size: tuple[int, int], plan, fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """EASU-resize a contiguous f32 CUDA (C, H, W) or (H, W) image to
    `out_size`, placing samples by `plan` (an ops/easu.ScalePlan: the exact
    rational form, or the f32 fallback); returns (C, OH, OW) f32 (or
    (OH, OW)).  The kernel's S = 1 launch."""
    if img.ndim not in (2, 3):
        raise ValueError(f"easu_scale kernel takes (C<={_MAX_CHANNELS}, H, W), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("easu_scale kernel needs a contiguous image")
    out = torch.empty(img.shape[:-2] + tuple(out_size), dtype=torch.float32, device=img.device)
    _launch(img, out, 1, 0, 1 if img.ndim == 2 else img.shape[0], out_size, plan, fmt)
    easu_scale.launches += 1
    return out


def easu_scale_batched(
    imgs: torch.Tensor, out_size: tuple[int, int], plan, fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """EASU-resize S f32 CUDA frames, (S, C, H, W) or (S, H, W), to
    `out_size` in one launch; returns (S, C, OH, OW) (or (S, OH, OW)).
    Each stream's frame must be contiguous; a frame broadcast over streams
    (stream stride 0, as `expand` makes it) is read in place."""
    if imgs.ndim not in (3, 4):
        raise ValueError(f"easu_scale_batched takes (S, C, H, W) frames, got {tuple(imgs.shape)}")
    n = imgs.shape[0]
    if not 1 <= n <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, got {n}")
    if not blocks_contiguous(imgs):
        raise ValueError("easu_scale kernel needs each stream's frame contiguous")
    out = torch.empty(imgs.shape[:-2] + tuple(out_size), dtype=torch.float32, device=imgs.device)
    _launch(imgs, out, n, imgs.stride(0), 1 if imgs.ndim == 3 else imgs.shape[1], out_size,
            plan, fmt)
    easu_scale_batched.launches += 1
    return out


easu_scale.launches = 0
easu_scale_batched.launches = 0
