"""DeblockingFilter: adaptive macroblock deblocking (counterpart of
livevisionkit_tpu/filters/deblocking.py; reference Filters/
DeblockingFilter.cpp:48-112).

Smooth frame = upscale(medianBlur(downscale(frame, 1/scaling), k))
(:73-77); blockiness = per-block mean |luma - block mean| (:79-84); keep =
min(floor(blockiness on the 8-bit scale), levels) / levels per block
(:86-95), bilinearly upsampled; out = keep * frame + (1 - keep) * smooth
(:100-107).  The frame is edge-padded up to whole blocks, and partial
border blocks pass through untouched (keep 1), the reference's
crop-not-pad semantics (:64-71).

The plain path on the CPU, K8 on the card: the step is the custom op
``lvk::deblock``, which for CUDA tensors runs the two deblocker kernels
(ops/cuda_kernels/deblock.deblock: a reduce pass for the pooled frame and
the keep map, a blend pass with the median in registers) and for CPU ones
`deblock_plain`, the plain composition, as in the JAX package, which has
no Pallas kernel for it (dense XLA ops there).  Its vmap rule makes
`torch.func.vmap` over streams one call of ``lvk::deblock_batched``.  One
block-mean form (the JAX package's choice between a reshape and a windowed
sum, `pool_form`, is an XLA relayout workaround, not ported).  Stateless
and free of host syncs: the partial border is decided from static shapes.
`influence_map` (debug overlays) stays plain on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.config import DeblockingFilterSettings
from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import VideoFilter
from livevisionkit_tpu_torch.ops import color as color_ops
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.ops.cuda_kernels import deblock as deblock_kernel
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import stream_first
from livevisionkit_tpu_torch.utils.profiling import trace_scope


def block_measure(gray: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block mean |luma - block mean| of a (H, W) luma whose sides
    are whole blocks: the blockiness measure on the [0, 1] scale."""
    reference = resample.upsample_nearest_int(resample.avg_pool(gray, block), block)
    return resample.avg_pool((gray - reference).abs(), block)


def keep_blocks(measure: torch.Tensor, levels: int) -> torch.Tensor:
    """Multi-level threshold of the blockiness: the reference thresholds the
    8-bit measure at integer levels l = 0..L-1 and writes (l+1)/L, i.e.
    keep = min(floor(255 measure), L) / L (flat blocks smooth fully)."""
    return torch.clamp(torch.floor(measure * 255.0), max=float(levels)) / levels


def deblock_plain(pixels: torch.Tensor, fmt: PixelFormat, block: int, scaling: int, ksize: int,
                  levels: int) -> torch.Tensor:
    """The deblocker on (C, H, W) planes as plain PyTorch ops on any device:
    the CPU path of ``lvk::deblock``, and the reference the deblocker
    kernels are held against on the card."""
    _, h, w = pixels.shape
    fh, fw = (h // block) * block, (w // block) * block  # whole blocks
    ph, pw = -(-h // block) * block, -(-w // block) * block
    px = pixels
    if (ph, pw) != (h, w):
        px = F.pad(px[None], (0, pw - w, 0, ph - h), mode="replicate")[0]

    # Smooth frame (:73-77): a padded side is a whole number of blocks, so
    # of scaling steps too, and INTER_AREA is the block mean.
    small = resample.median_blur_plain(resample.avg_pool(px, scaling), ksize)
    smooth = resample.upsample_linear_int(small, (scaling, scaling))

    measure = block_measure(color_ops.luma(px, fmt), block)
    keep = resample.upsample_linear_int(keep_blocks(measure, levels), (block, block))
    keep, smooth = keep[:h, :w], smooth[:, :h, :w]
    if (fh, fw) != (h, w):  # partial border blocks pass through (:64-71)
        yy = torch.arange(h, device=px.device)[:, None]
        xx = torch.arange(w, device=px.device)[None, :]
        keep = torch.where((yy >= fh) | (xx >= fw), 1.0, keep)

    return pixels * keep[None] + smooth * (1.0 - keep[None])


def deblock_batched_plain(pixels: torch.Tensor, fmt: PixelFormat, block: int, scaling: int,
                          ksize: int, levels: int) -> torch.Tensor:
    """`deblock_plain` over a leading stream axis, by torch.func.vmap: the
    batched op's CPU path, and the reference the kernels' stream axis is
    held against on the card."""
    return torch.func.vmap(lambda p: deblock_plain(p, fmt, block, scaling, ksize, levels))(pixels)


_SCHEMA = "(Tensor px, str fmt, int block, int scaling, int ksize, int levels) -> Tensor"


@torch.library.custom_op("lvk::deblock", mutates_args=(), schema=_SCHEMA)
def _deblock_op(px, fmt, block, scaling, ksize, levels):
    """One frame: the deblocker kernels for a CUDA tensor, `deblock_plain`
    for a CPU one."""
    fmt = PixelFormat(fmt)
    if px.is_cuda:
        return deblock_kernel.deblock(px.contiguous(), color_ops.luma_weights(fmt), block,
                                      scaling, ksize, levels)
    return deblock_plain(px, fmt, block, scaling, ksize, levels)


@torch.library.custom_op("lvk::deblock_batched", mutates_args=(), schema=_SCHEMA)
def _deblock_batched_op(px, fmt, block, scaling, ksize, levels):
    """S frames (S, C, H, W), stream axis first: one call of the deblocker
    kernels for CUDA tensors, `deblock_batched_plain` for CPU ones."""
    fmt = PixelFormat(fmt)
    if px.is_cuda:
        return deblock_kernel.deblock(px, color_ops.luma_weights(fmt), block, scaling, ksize,
                                      levels)
    return deblock_batched_plain(px, fmt, block, scaling, ksize, levels)


@_deblock_op.register_fake
@_deblock_batched_op.register_fake
def _deblock_fake(px, fmt, block, scaling, ksize, levels):
    return px.new_empty(px.shape)


def _deblock_vmap(info, in_dims, px, fmt, block, scaling, ksize, levels):
    """vmap rule of ``lvk::deblock``: all streams in one batched call; an
    unbatched frame is broadcast at stream stride 0, not copied."""
    px = stream_first(px, in_dims[0], info.batch_size)
    return _deblock_batched_op(px, fmt, block, scaling, ksize, levels), 0


_deblock_op.register_vmap(_deblock_vmap)


@dataclass(frozen=True)
class DeblockingFilter(VideoFilter):
    settings: DeblockingFilterSettings = field(default_factory=DeblockingFilterSettings)

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        with trace_scope("deblock"):
            return state, self._deblock(frame)

    def _deblock(self, frame: Frame) -> Frame:
        s = self.settings
        return frame.with_pixels(_deblock_op(frame.pixels, frame.format.value, s.block_size,
                                             s.filter_scaling, s.filter_size, s.detection_levels))

    def influence_map(self, frame: Frame) -> torch.Tensor:
        """(H, W) smoothing weight in [0, 1] for debug overlays (reference
        draw_influence, DeblockingFilter.cpp:114-131); 0 outside the whole
        blocks."""
        s = self.settings
        block = s.block_size
        _, h, w = frame.pixels.shape
        fh, fw = (h // block) * block, (w // block) * block
        measure = block_measure(color_ops.luma(frame.pixels[:, :fh, :fw], frame.format), block)
        keep = resample.upsample_linear_int(keep_blocks(measure, s.detection_levels), (block, block))
        return F.pad(1.0 - keep, (0, w - fw, 0, h - fh))
