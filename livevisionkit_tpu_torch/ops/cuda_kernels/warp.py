"""Launch wrappers of the EASU / bilinear warp kernel (csrc/warp.cu): `warp`
for one frame and `warp_batched` for a stack of S streams, one launch each.

Replaces livevisionkit_tpu/ops/tpu_kernels/warp.py::pallas_remap (bodies
``_easu_kernel`` and ``_kernel``) and ::pallas_remap_batched (bodies
``_easu_kernel_batched`` and ``_kernel_batched``): the solo warp is the
S = 1 launch of the same kernel, whose grid has the stream axis.  Their
plain versions are ops/remap.remap_plain and ops/remap.remap_batched_plain
(ops/easu.easu_remap and ops/remap.bilinear_sample, under torch.func.vmap
for the batch), which they match borders included.

What bounds it on the H100: arithmetic.  An EASU output pixel costs ~430
f32 operations, and each source pixel 27 more for its direction terms,
against 8 bytes of sample map and 2 x C bytes of u8 source and output, so
a 1080p u8 YUV warp needs ~14 us of the card's f32 rate and ~9 us of its
memory rate.  Its design (csrc/warp.cu, csrc/easu.cuh): one kernel per
channel count (no dead channel); a block owns a 32 x 32 output tile,
stages its samples' source box in shared memory as float texels (a u8
frame with word-aligned rows by 32-bit loads) and computes each source
pixel's direction terms once for every output that uses it; a tile whose
box exceeds the kernel's capacity gathers from device memory
(`block_paths` counts such tiles).  The bilinear mode gathers its 4 taps
per output through the read-only cache.  S streams are S z-slices of one grid; an
operand that every stream shares (a broadcast map under vmap) is read at
stream stride 0, never copied.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_CHANNELS = 4
_MAX_STREAMS = 65535


def _launch(imgs, smaps, out, n_streams, img_ss, map_ss, c, fill, filter_mode, fmt,
            block_paths) -> None:
    """Checks shared by both wrappers, then one launch: `n_streams` frames
    of `c` contiguous (H, W) planes, img_ss elements apart, each warped by
    a contiguous (2, H', W') map, map_ss apart, into the contiguous `out`."""
    if not (imgs.is_cuda and smaps.is_cuda) or imgs.device != smaps.device:
        raise ValueError("warp kernel needs the image and the map on one CUDA device")
    if block_paths is not None and not (block_paths.device == imgs.device
                                        and block_paths.dtype == torch.int32
                                        and block_paths.shape == (2,)):
        raise ValueError("block_paths must be a (2,) int32 tensor on the image's device")
    if imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"warp kernel takes u8 or f32 images, got {imgs.dtype}")
    if smaps.dtype != torch.float32:
        raise TypeError(f"sample map must be f32, got {smaps.dtype}")
    if filter_mode not in ("easu", "bilinear"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"warp kernel takes 1..{_MAX_CHANNELS} channels, got {c}")
    rgb_luma = filter_mode == "easu" and fmt not in (PixelFormat.YUV, PixelFormat.GRAY)
    if rgb_luma and c < 3:
        raise ValueError(f"EASU luma of {fmt} needs 3 channels, got {c}")
    h, w = imgs.shape[-2:]
    oh, ow = smaps.shape[-2:]
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(imgs.device):
        status = build.library().lvk_warp_counted(
            imgs.data_ptr(), smaps.data_ptr(), out.data_ptr(), n_streams, img_ss, map_ss,
            c, h, w, oh, ow, int(imgs.dtype == torch.uint8), int(filter_mode == "easu"),
            int(fill is not None), 0.0 if fill is None else float(fill), int(rgb_luma),
            None if block_paths is None else block_paths.data_ptr(),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    build.check(status, "warp")


def warp(
    img: torch.Tensor,
    sample_map: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "easu",
    fmt: PixelFormat = PixelFormat.YUV,
    block_paths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warp a CUDA (C, H, W) or (H, W) u8/f32 image by a (2, H', W') f32
    absolute (y, x) map; returns (C, H', W') (or (H', W')) of the image's
    dtype.  `fill` is a scalar on the image's own scale (0..255 for u8), or
    None for replicate borders.  The kernel's S = 1 launch.

    `block_paths`, a (2,) int32 tensor on the image's device, makes an EASU
    launch add to it the kernel's blocks that hold an EASU sample and, of
    those, the blocks whose source box exceeds the kernel's shared-memory
    box and which gather from device memory."""
    if img.ndim not in (2, 3) or sample_map.ndim != 3 or sample_map.shape[0] != 2:
        raise ValueError(f"warp takes a (C, H, W) image and a (2, H, W) map, got "
                         f"{tuple(img.shape)} and {tuple(sample_map.shape)}")
    if not (img.is_contiguous() and sample_map.is_contiguous()):
        raise ValueError("warp kernel needs contiguous image and map")
    c = 1 if img.ndim == 2 else img.shape[0]
    out = torch.empty(img.shape[:-2] + sample_map.shape[1:], dtype=img.dtype, device=img.device)
    _launch(img, sample_map, out, 1, 0, 0, c, fill, filter_mode, fmt, block_paths)
    warp.launches += 1
    return out


def warp_batched(
    imgs: torch.Tensor,
    sample_maps: torch.Tensor,
    fill: float | None = 0.0,
    filter_mode: str = "easu",
    fmt: PixelFormat = PixelFormat.YUV,
    block_paths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warp S CUDA frames, (S, C, H, W) or (S, H, W), each by its own
    (S, 2, H', W') map, in one launch; returns (S, C, H', W') (or
    (S, H', W')).  Each stream's frame and map must be contiguous; an
    operand broadcast over streams (stream stride 0, as `expand` makes it)
    is read in place.  `block_paths` as in `warp`, over all streams."""
    if imgs.ndim not in (3, 4) or sample_maps.ndim != 4 or sample_maps.shape[1] != 2:
        raise ValueError(f"warp_batched takes (S, C, H, W) frames and (S, 2, H, W) maps, got "
                         f"{tuple(imgs.shape)} and {tuple(sample_maps.shape)}")
    n = imgs.shape[0]
    if sample_maps.shape[0] != n or not 1 <= n <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, one map each; got {n} frames, "
                         f"{sample_maps.shape[0]} maps")
    if not (blocks_contiguous(imgs) and blocks_contiguous(sample_maps)):
        raise ValueError("warp kernel needs each stream's frame and map contiguous")
    c = 1 if imgs.ndim == 3 else imgs.shape[1]
    out = torch.empty(imgs.shape[:-2] + sample_maps.shape[2:], dtype=imgs.dtype,
                      device=imgs.device)
    _launch(imgs, sample_maps, out, n, imgs.stride(0), sample_maps.stride(0), c, fill,
            filter_mode, fmt, block_paths)
    warp_batched.launches += 1
    return out


warp.launches = 0
warp_batched.launches = 0

