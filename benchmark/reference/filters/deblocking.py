"""The deblocker in plain PyTorch, frozen here as the reference of the port's
`DeblockingFilter` (reference Filters/DeblockingFilter.cpp:48-112): smooth =
upscale(medianBlur(block-mean downscale by `filter_scaling`, `filter_size`)),
blockiness = per-block mean |luma - block mean|, keep = min(floor(255
blockiness), levels) / levels per block, bilinearly upsampled, out = keep *
frame + (1 - keep) * smooth; the frame is edge-padded to whole blocks and
partial border blocks pass through."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool(img: torch.Tensor, block: int) -> torch.Tensor:
    *lead, h, w = img.shape
    return img.reshape(*lead, h // block, block, w // block, block).mean(dim=(-3, -1))


def _up_nearest(img: torch.Tensor, k: int) -> torch.Tensor:
    *lead, h, w = img.shape
    return img[..., :, None, :, None].expand(*lead, h, k, w, k).reshape(*lead, h * k, w * k)


def _up_linear(img: torch.Tensor, k: int) -> torch.Tensor:
    """Integer-factor bilinear upsample, half-pixel centres, edge clamp."""
    *lead, h, w = img.shape
    out = F.interpolate(img.reshape(1, -1, h, w), size=(h * k, w * k), mode="bilinear", align_corners=False)
    return out.reshape(*lead, h * k, w * k)


def _median(img: torch.Tensor, k: int) -> torch.Tensor:
    """k x k median, reflect-101 padded (cv::medianBlur)."""
    r = k // 2
    *lead, h, w = img.shape
    x = F.pad(img.reshape(1, -1, h, w), (r, r, r, r), mode="reflect").reshape(*lead, h + 2 * r, w + 2 * r)
    views = torch.stack([x[..., dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)])
    return torch.median(views, dim=0).values


def apply(px: torch.Tensor, settings: dict) -> torch.Tensor:
    """Deblock (3, H, W) YUV planes (luma = plane 0)."""
    block, scaling = settings["block_size"], settings["filter_scaling"]
    levels = settings["detection_levels"]
    _, h, w = px.shape
    fh, fw = (h // block) * block, (w // block) * block
    ph, pw = -(-h // block) * block, -(-w // block) * block
    padded = px if (ph, pw) == (h, w) else F.pad(px[None], (0, pw - w, 0, ph - h), mode="replicate")[0]
    smooth = _up_linear(_median(_avg_pool(padded, scaling), settings["filter_size"]), scaling)
    luma = padded[0]
    measure = _avg_pool((luma - _up_nearest(_avg_pool(luma, block), block)).abs(), block)
    keep = torch.clamp(torch.floor(measure * 255.0), max=float(levels)) / levels
    keep = _up_linear(keep, block)[:h, :w]
    smooth = smooth[:, :h, :w]
    if (fh, fw) != (h, w):
        yy = torch.arange(h, device=px.device)[:, None]
        xx = torch.arange(w, device=px.device)[None, :]
        keep = torch.where((yy >= fh) | (xx >= fw), 1.0, keep)
    return px * keep[None] + smooth * (1.0 - keep[None])
