"""Launch wrappers of the deblocker's kernels (csrc/deblock.cu, K8):
`median_blur`, the k x k median of f32 planes, and `deblock`, the whole
smoothing path of filters/deblocking.py in two launches, solo or over a
leading stream axis.

Replaces no TPU kernel: the JAX package leaves the deblocker to XLA.  The
plain versions are ops/resample.median_blur_plain (25 stacked shifted
copies and `torch.median`) and filters/deblocking.deblock_plain (a dozen
passes over the frame around it), under torch.func.vmap for the batch.
The median kernel equals its plain version bit for bit; the deblocker
kernels sum in another order and equal theirs to float rounding.

What bounds it on the H100: bytes.  At 3 x 2160 x 3840 f32 the frame is
read twice and the output written once, ~311 MB with the pooled frame and
the keep map, 0.093 ms at 3.35 TB/s; the median, ~100 min/max operations
on each of 1.55 M pooled values, is a few microseconds of the SMs.  The
design (csrc/deblock.cu): `deblock_reduce` reads the frame once by
16-byte loads, a band of blocks in shared memory, and writes only the
pooled frame and the keep map; `deblock_blend` takes each tile's medians
into shared memory by the selection network in registers, then reads each
pixel once, upsamples both maps in registers and writes the blend.  The
padded frame, the upsampled maps and the 25-copy stack never reach device
memory.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.ops.cuda_kernels.median_net import KSIZES
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_CHANNELS = 4
_MAX_STREAMS = 65535
_TILE_COLS = 256  # csrc/deblock.cu: kTileCols
_MAX_SMEM = 232448  # kMaxSmem


def _check_ksize(ksize: int) -> None:
    if ksize not in KSIZES:
        raise ValueError(f"the median kernel takes ksize {KSIZES}, got {ksize}")


def _check_f32_cuda(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes f32, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{what} kernel needs a CUDA tensor")


def median_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize median (3, 5 or 7), reflect-101 borders, of a
    contiguous f32 CUDA (..., H, W) tensor, each (H, W) plane on its own,
    in one launch; H and W must exceed ksize // 2, as reflect padding needs."""
    _check_f32_cuda(img, "median")
    _check_ksize(ksize)
    if img.ndim < 2:
        raise ValueError(f"median kernel takes (..., H, W), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("median kernel needs a contiguous tensor")
    h, w = img.shape[-2:]
    if min(h, w) <= ksize // 2:
        raise ValueError(f"median kernel needs H and W above {ksize // 2}, got {h}x{w}")
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        status = build.library().lvk_median_blur(
            img.data_ptr(), out.data_ptr(), img.numel() // (h * w), h, w, ksize,
            torch.cuda.current_stream(img.device).cuda_stream)
    build.check(status, "median_blur")
    median_blur.launches += 1
    return out


def deblock(px: torch.Tensor, luma: tuple[float, float, float] | None, block: int,
            scaling: int, ksize: int, levels: int) -> torch.Tensor:
    """The deblocker (filters/deblocking.deblock_plain) on f32 CUDA (C, H, W)
    planes, or (S, C, H, W) for S streams (each stream's frame contiguous;
    a stream stride of 0 reads one frame for all), C <= 4: two launches,
    counted as one call.  `luma` is None to take plane 0 as the luma, or
    the weights of planes 0..2.  block % scaling == 0, the pooled frame's
    sides above ksize // 2, and 2 x block x (the reduce tile's width) f32
    in a block's shared memory.  Returns a new contiguous tensor of px's
    shape."""
    _check_f32_cuda(px, "deblock")
    _check_ksize(ksize)
    batched = px.ndim == 4
    if px.ndim not in (3, 4):
        raise ValueError(f"deblock kernel takes (C, H, W) or (S, C, H, W), got {tuple(px.shape)}")
    s = px.shape[0] if batched else 1
    c, h, w = px.shape[-3:]
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"deblock kernel takes 1..{_MAX_CHANNELS} planes, got {c}")
    if luma is not None and c < 3:
        raise ValueError(f"a weighted luma needs 3 planes, got {c}")
    if not 1 <= s <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, got {s}")
    if not (blocks_contiguous(px) if batched else px.is_contiguous()):
        raise ValueError("deblock kernel needs each stream's frame contiguous")
    if block < 1 or scaling < 1 or block % scaling or levels < 1:
        raise ValueError(f"deblock kernel needs block % scaling == 0 and levels >= 1, got "
                         f"block {block}, scaling {scaling}, levels {levels}")
    tile = block * max(1, _TILE_COLS // block)
    if 2 * 4 * block * tile > _MAX_SMEM:
        raise ValueError(f"deblock kernel takes blocks that fit its shared memory, got {block}")
    kh, kw = -(-h // block), -(-w // block)
    sh, sw = kh * block // scaling, kw * block // scaling
    if min(sh, sw) <= ksize // 2:
        raise ValueError(f"deblock kernel needs the pooled frame's sides above {ksize // 2}, "
                         f"got {sh}x{sw}")
    dev = px.device
    out = torch.empty((s, c, h, w), dtype=torch.float32, device=dev)
    small = torch.empty((s, c, sh, sw), dtype=torch.float32, device=dev)
    keep = torch.empty((s, kh, kw), dtype=torch.float32, device=dev)
    lw = (0.0, 0.0, 0.0) if luma is None else tuple(float(v) for v in luma)
    with torch.cuda.device(dev):
        status = build.library().lvk_deblock(
            px.data_ptr(), px.stride(0) if batched else 0, s, c, h, w, block, scaling, ksize,
            levels, 0 if luma is None else 1, *lw, small.data_ptr(), keep.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "deblock")
    deblock.launches += 1
    return out if batched else out[0]


# Calls of each wrapper, solo or batched (a deblock call is two launches).
median_blur.launches = 0
deblock.launches = 0
