"""Spatial (tile) sharding with explicit halo exchange (counterpart of
livevisionkit_tpu/parallel/spatial.py).

A frame's W axis splits into one stripe per device of the mesh's "tile"
axis; a warp needs source pixels up to its displacement bound beyond each
stripe's edges, so each stripe takes a `halo` of columns from each
neighbour (a copy to its device: the JAX package's `ppermute`, neighbour
traffic only, never an all-gather), then each device warps its own output
stripe from its halo-padded stripe.  At the frame's outer edges the warp's
own edge replication stands in for the JAX package's replicated halo.  On a CUDA stripe that is the warp
kernel K1 (csrc/warp.cu), launched once per tile on a source wider than its
output; on a CPU stripe it is K1's plain version.  A mesh that mixes CPU
and CUDA devices raises.  Devices may repeat: on one card every tile is
``cuda:0`` and the copies between them are views.

`filter_mode="easu"` is the reference-parity filtered warp
(WarpMesh.cpp:183-223 -> FSR.cl:362-403).

Borders.  The JAX package pads the frame's outer edges with a replicated
halo, so its warp's nearest-neighbour ring (FSR.cl:385-397) and `fill` fall
at the stripe's bounds, not the frame's, and it re-applies both against
global coordinates after the warp.  Here the outer edges take no halo and
the local map is left unclamped on them: the stripe's bounds there ARE the
frame's, so the warp's own ring, fill and edge replication are the global
ones, and within the halo every tile is the unsharded warp of its pixels,
bit for bit.  The halo must cover the warp's largest displacement (the
stabilizer's corrective limit by construction); a larger one clamps to
the halo's edge, as in the JAX package.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops import remap as remap_ops
from livevisionkit_tpu_torch.parallel.streams import Mesh
from livevisionkit_tpu_torch.types import PixelFormat


def _stripes(
    img: torch.Tensor, sample_map: torch.Tensor, devices: list[torch.device], halo: int
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per tile, on its device: the contiguous halo-padded source stripe and
    the contiguous stripe-local (2, H, W / n) map.  `halo` is at most the
    stripe width; a single tile is the whole frame."""
    n = len(devices)
    local_w = img.shape[-1] // n
    # The sharded input: stripe i on tile device i.
    own = [img[:, :, i * local_w:(i + 1) * local_w].to(d) for i, d in enumerate(devices)]
    maps = [sample_map[:, :, i * local_w:(i + 1) * local_w].to(d) for i, d in enumerate(devices)]
    out = []
    for i, d in enumerate(devices):
        left = [own[i - 1][:, :, local_w - halo:].to(d)] if i > 0 else []
        right = [own[i + 1][:, :, :halo].to(d)] if i < n - 1 else []
        padded = torch.cat([*left, own[i], *right], dim=2)
        # Local x: the global x less a non-negative integer (exact in
        # float32), clamped to the halo on the sides that have one; the
        # frame's own edges are left to the warp.
        xs = maps[i][1] - float(i * local_w - (halo if left else 0))
        if left or right:
            xs = torch.clamp(xs, min=0.0 if left else None,
                             max=float(padded.shape[-1] - 1) if right else None)
        out.append((padded, torch.stack([maps[i][0], xs])))
    return out


def remap_sharded(
    img: torch.Tensor,  # (C, H, W), W divisible by the axis size
    sample_map: torch.Tensor,  # (2, H, W) absolute coords
    mesh: Mesh,
    fill: float | None = 0.0,
    axis: str = "tile",
    halo: int = 192,
    filter_mode: str = "bilinear",
    fmt: PixelFormat | None = None,
    margin: int = 32,
) -> torch.Tensor:
    """Backward-warp `img` (u8 or f32) with W split over the mesh's `axis`
    (its devices at index 0 of any other axis) and halo exchange; returns
    the (C, H, W) result on the axis's first device.

    filter_mode: "bilinear" or "easu" (`fmt` drives EASU's luma, default
    YUV).  `fill` is on the image's own scale (0..255 for u8), None for
    replicate borders, as in ops/remap.remap.  `margin`, the JAX Pallas
    kernel's residual bound after its per-stripe mean shift, has no
    counterpart in K1 and is ignored."""
    del margin
    if filter_mode not in ("bilinear", "easu"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    fmt = PixelFormat.YUV if fmt is None else fmt
    devices = mesh.along(axis)
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"the {axis} axis mixes device types: {devices}")
    if img.ndim != 3:
        raise ValueError(f"remap_sharded takes a (C, H, W) image, got {tuple(img.shape)}")
    w, n = img.shape[-1], len(devices)
    if w % n:
        raise ValueError(f"W={w} must divide over the {axis} axis ({n})")
    halo = min(halo, w // n)
    # K1 on a CUDA stripe, its plain version on a CPU one (lvk::remap).
    parts = [remap_ops.remap(padded, local_map, fill=fill, filter_mode=filter_mode, fmt=fmt)
             .to(devices[0]) for padded, local_map in _stripes(img, sample_map, devices, halo)]
    return torch.cat(parts, dim=2)
