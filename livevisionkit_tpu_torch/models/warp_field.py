"""WarpField: the mesh-warp motion model (counterpart of
livevisionkit_tpu/models/warp_field.py; reference Math/WarpMesh).

Offsets are one (2, Hm, Wm) float32 tensor, plane 0 = dy, plane 1 = dx, in
normalized units (1.0 = frame height/width - 1), with corner-aligned
control points.  Warping image I by a field f gives
O(u) = I(u_px + f(u) * (size - 1)): backward offsets, like the reference.

This slice ports the exact 2x2 (homography) path; general meshes wait for
ROADMAP slice 2 (mesh mode).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.models.homography import Homography
from livevisionkit_tpu_torch.ops import remap as remap_ops
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass


def _to_px(offsets: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Normalized (2, ...) (y, x) offsets -> pixels.  Plane by plane with
    Python scalars: a small tensor built from host values would be a
    host-to-device copy, which synchronizes the stream."""
    h, w = size
    return torch.stack([offsets[0] * (h - 1), offsets[1] * (w - 1)])


def _to_norm(off_px: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    h, w = size
    return torch.stack([off_px[0] / (h - 1), off_px[1] / (w - 1)])


def _grid_points_px(field_shape: tuple[int, int], size: tuple[int, int], device) -> torch.Tensor:
    """(2, Hm, Wm) pixel positions of corner-aligned field control points."""
    hm, wm = field_shape
    h, w = size
    yy = torch.arange(hm, dtype=torch.float32, device=device)[:, None].expand(hm, wm)
    xx = torch.arange(wm, dtype=torch.float32, device=device)[None, :].expand(hm, wm)
    return torch.stack([yy * ((h - 1) / (hm - 1)), xx * ((w - 1) / (wm - 1))])


def _grid_unit(field_shape: tuple[int, int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized [0, 1] (y, x) coordinates of the control points."""
    hm, wm = field_shape
    yy = torch.arange(hm, dtype=torch.float32, device=device)[:, None].expand(hm, wm) / (hm - 1)
    xx = torch.arange(wm, dtype=torch.float32, device=device)[None, :].expand(hm, wm) / (wm - 1)
    return yy, xx


@pytree_dataclass()
@dataclass(frozen=True)
class WarpField:
    offsets: torch.Tensor  # (2, Hm, Wm) normalized backward offsets (dy, dx)

    @property
    def field_shape(self) -> tuple[int, int]:
        return tuple(self.offsets.shape[-2:])

    @classmethod
    def identity(cls, field_shape: tuple[int, int], device: torch.device | str = "cuda") -> "WarpField":
        return cls(offsets=torch.zeros((2,) + tuple(field_shape), dtype=torch.float32, device=device))

    @classmethod
    def from_homography(
        cls, h: Homography, field_shape: tuple[int, int], size: tuple[int, int]
    ) -> "WarpField":
        """Field whose warp reproduces `h.warp` at the control points:
        o(u) = H^-1(u) - u, normalized (reference WarpMesh::set_to)."""
        dev = h.m.device
        pts_px = _grid_points_px(tuple(field_shape), size, dev)  # (2, Hm, Wm) (y, x)
        xy = torch.stack([pts_px[1], pts_px[0]], dim=-1)  # (Hm, Wm, 2) (x, y)
        src_xy = h.inverse().transform(xy.reshape(-1, 2)).reshape(xy.shape)
        off_px = torch.stack([src_xy[..., 1] - pts_px[0], src_xy[..., 0] - pts_px[1]])
        return cls(offsets=_to_norm(off_px, size))

    def to_homography(self, size: tuple[int, int]) -> Homography:
        """Exact homography through the 4 corner offsets (the reference's
        2x2-mesh fast path, WarpMesh.cpp:196-218)."""
        pts_px = _grid_points_px(self.field_shape, size, self.offsets.device)
        src = pts_px + _to_px(self.offsets, size)
        corners = [(0, 0), (0, -1), (-1, 0), (-1, -1)]
        dst_q = torch.stack([torch.stack([pts_px[1, i, j], pts_px[0, i, j]]) for i, j in corners])
        src_q = torch.stack([torch.stack([src[1, i, j], src[0, i, j]]) for i, j in corners])
        # out(dst) = in(src) = in(H^-1(dst)): H maps src -> dst.
        return Homography.from_quad(src_q, dst_q)

    # ---- algebra (reference WarpMesh.cpp:318-560) -------------------------

    def __add__(self, other: "WarpField") -> "WarpField":
        return WarpField(offsets=self.offsets + other.offsets)

    def __sub__(self, other: "WarpField") -> "WarpField":
        return WarpField(offsets=self.offsets - other.offsets)

    def __mul__(self, s) -> "WarpField":
        return WarpField(offsets=self.offsets * s)

    __rmul__ = __mul__

    def clamp(self, limits_y, limits_x) -> "WarpField":
        """Clamp normalized offsets into +/- limits (corrective limits)."""
        dy = torch.clamp(self.offsets[0], -limits_y, limits_y)
        dx = torch.clamp(self.offsets[1], -limits_x, limits_x)
        return WarpField(offsets=torch.stack([dy, dx]))

    def compose(self, outer: "WarpField") -> "WarpField":
        """First warp by `outer`, then by self: c(u) = outer.o(u) +
        self.o(u + outer.o(u)) (reference WarpMesh::combine)."""
        if outer.field_shape != self.field_shape:
            raise NotImplementedError(
                "composing fields of different shapes needs the corner-aligned "
                "resize (ROADMAP slice 2, mesh mode)"
            )
        hm, wm = self.field_shape
        o = outer.offsets
        yy, xx = _grid_unit((hm, wm), o.device)
        sy = (yy + o[0]) * (hm - 1)
        sx = (xx + o[1]) * (wm - 1)
        inner_at = remap_ops.bilinear_sample(self.offsets, sy, sx, fill=None)
        return WarpField(offsets=o + inner_at)

    def apply(
        self,
        img: torch.Tensor,
        fill: float | None = 0.0,
        filter_mode: str = "easu",
        fmt=None,
    ) -> torch.Tensor:
        """Warp a (C, H, W) / (H, W) image by this field.  A 2x2 field takes
        the exact homography path, like the reference (WarpMesh.cpp:196-218)."""
        if self.field_shape != (2, 2):
            raise NotImplementedError(
                "WarpField.apply on a non-2x2 field is mesh mode (ROADMAP slice 2)"
            )
        return self.to_homography(img.shape[-2:]).warp(
            img, fill=fill, filter_mode=filter_mode, fmt=fmt
        )
