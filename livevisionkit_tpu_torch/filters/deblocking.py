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

Plain PyTorch ops on any device, as in the JAX package, which has no
Pallas kernel for it (dense XLA ops there): one block-mean form (the JAX
package's choice between a reshape and a windowed sum, `pool_form`, is an
XLA relayout workaround, not ported).  Stateless and free of host syncs:
the partial border is decided from static shapes.
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


@dataclass(frozen=True)
class DeblockingFilter(VideoFilter):
    settings: DeblockingFilterSettings = field(default_factory=DeblockingFilterSettings)

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        with trace_scope("deblock"):
            return state, self._deblock(frame)

    def _deblock(self, frame: Frame) -> Frame:
        s = self.settings
        block = s.block_size
        _, h, w = frame.pixels.shape
        fh, fw = (h // block) * block, (w // block) * block  # whole blocks
        ph, pw = -(-h // block) * block, -(-w // block) * block
        px = frame.pixels
        if (ph, pw) != (h, w):
            px = F.pad(px[None], (0, pw - w, 0, ph - h), mode="replicate")[0]

        # Smooth frame (:73-77): a padded side is a whole number of blocks,
        # so of scaling steps too, and INTER_AREA is the block mean.
        small = resample.median_blur(resample.avg_pool(px, s.filter_scaling), s.filter_size)
        smooth = resample.upsample_linear_int(small, (s.filter_scaling, s.filter_scaling))

        measure = block_measure(color_ops.luma(px, frame.format), block)
        keep = resample.upsample_linear_int(keep_blocks(measure, s.detection_levels), (block, block))
        keep, smooth = keep[:h, :w], smooth[:, :h, :w]
        if (fh, fw) != (h, w):  # partial border blocks pass through (:64-71)
            yy = torch.arange(h, device=px.device)[:, None]
            xx = torch.arange(w, device=px.device)[None, :]
            keep = torch.where((yy >= fh) | (xx >= fw), 1.0, keep)

        out = frame.pixels * keep[None] + smooth * (1.0 - keep[None])
        return frame.with_pixels(out)

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
