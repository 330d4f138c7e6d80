"""WarpField: the mesh-warp motion model (counterpart of
livevisionkit_tpu/models/warp_field.py; reference Math/WarpMesh).

Offsets are one (2, Hm, Wm) float32 tensor, plane 0 = dy, plane 1 = dx, in
normalized units (1.0 = frame height/width - 1), with corner-aligned
control points.  Warping image I by a field f gives
O(u) = I(u_px + f(u) * (size - 1)): backward offsets, like the reference.

A 2x2 field warps by its exact homography (the flagship's global mode,
WarpMesh.cpp:196-218); any other field (mesh mode, e.g. 16x16) upsamples
its offsets to a dense (2, H, W) sample map and warps through the same
custom op `ops/remap.remap`, so on the card both modes run the warp kernel
K1.  Every method works on the offsets' device and builds no tensor from
host values, so none of them synchronizes the stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.models.homography import Homography
from livevisionkit_tpu_torch.ops import remap as remap_ops
from livevisionkit_tpu_torch.ops import resample
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

    def __neg__(self) -> "WarpField":
        return WarpField(offsets=-self.offsets)

    def lerp(self, other: "WarpField", t) -> "WarpField":
        """Blend toward `other` (reference WarpMesh::blend)."""
        return WarpField(offsets=self.offsets + (other.offsets - self.offsets) * t)

    def clamp(self, limits_y, limits_x) -> "WarpField":
        """Clamp normalized offsets into +/- limits (corrective limits)."""
        dy = torch.clamp(self.offsets[0], -limits_y, limits_y)
        dx = torch.clamp(self.offsets[1], -limits_x, limits_x)
        return WarpField(offsets=torch.stack([dy, dx]))

    def scale(self, factors) -> "WarpField":
        """Append a zoom about the origin (reference WarpMesh::scale,
        WarpMesh.cpp:370-377): backward sampling at u/s adds
        u_n * (1/s - 1) to the normalized offsets.  `factors` = (sy, sx),
        numbers or 0-d tensors."""
        yy, xx = _grid_unit(self.field_shape, self.offsets.device)
        sy, sx = factors[0], factors[1]
        return WarpField(offsets=self.offsets + torch.stack([yy * (1.0 / sy - 1.0),
                                                             xx * (1.0 / sx - 1.0)]))

    def crop_in(self, tl, region_size) -> "WarpField":
        """Append a crop: the output span maps onto the normalized region
        [tl, tl + region_size) (reference WarpMesh::crop_in,
        WarpMesh.cpp:381-392).  tl and region_size as (y, x)."""
        yy, xx = _grid_unit(self.field_shape, self.offsets.device)
        return WarpField(offsets=self.offsets + torch.stack([
            yy * (region_size[0] - 1.0) + tl[0], xx * (region_size[1] - 1.0) + tl[1]]))

    def rotate(self, degrees) -> "WarpField":
        """Append a rotation of the sampling grid about the field centre
        (reference WarpMesh::rotate, WarpMesh.cpp:396-410: arm = (coord -
        centre) / size, offset += R(arm) - arm, with the reference's /size
        normalization).  `degrees` is a number or a 0-d tensor."""
        hm, wm = self.field_shape
        dev = self.offsets.device
        rad = torch.deg2rad(torch.as_tensor(degrees, dtype=torch.float32, device=dev))
        c, s = torch.cos(rad), torch.sin(rad)
        yy = (torch.arange(hm, dtype=torch.float32, device=dev)[:, None].expand(hm, wm)
              - (hm - 1) / 2) / hm
        xx = (torch.arange(wm, dtype=torch.float32, device=dev)[None, :].expand(hm, wm)
              - (wm - 1) / 2) / wm
        # Reference math is in (x, y): x' = x cos - y sin, y' = x sin + y cos.
        dx = (xx * c - yy * s) - xx
        dy = (xx * s + yy * c) - yy
        return WarpField(offsets=self.offsets + torch.stack([dy, dx]))

    def covers(self, region_tl, region_br, size: tuple[int, int]) -> torch.Tensor:
        """0-d bool: does warping a `size` frame by this field give in-frame
        content over the whole normalized region [region_tl, region_br]
        ((y, x) each)?  The map u + o(u) is bilinear within each mesh cell,
        so over a rectangle its extremes sit at corner evaluations: the
        control lines clipped to the region plus the region's edges cover
        every one (the general form of the reference's
        BoundingQuad::encloses, BoundingQuad.hpp:27-43)."""
        hm, wm = self.field_shape
        h, w = size
        (y0, x0), (y1, x1) = region_tl, region_br
        dev = self.offsets.device
        ys = torch.cat([torch.clamp(torch.arange(hm, dtype=torch.float32, device=dev) / (hm - 1),
                                    y0, y1), torch.linspace(y0, y1, 2, device=dev)])
        xs = torch.cat([torch.clamp(torch.arange(wm, dtype=torch.float32, device=dev) / (wm - 1),
                                    x0, x1), torch.linspace(x0, x1, 2, device=dev)])
        gy = ys[:, None].expand(ys.shape[0], xs.shape[0])
        gx = xs[None, :].expand(ys.shape[0], xs.shape[0])
        off = remap_ops.bilinear_sample(self.offsets, gy * (hm - 1), gx * (wm - 1), fill=None)
        sy = (gy + off[0]) * (h - 1)
        sx = (gx + off[1]) * (w - 1)
        return ((sy >= 0.0) & (sy <= h - 1) & (sx >= 0.0) & (sx <= w - 1)).all()

    def magnitude(self) -> torch.Tensor:
        """Per-point L2 offset magnitude (normalized units), (Hm, Wm)."""
        return torch.sqrt(torch.sum(self.offsets ** 2, dim=0))

    def resize(self, field_shape: tuple[int, int]) -> "WarpField":
        """Resample the control grid (corner-aligned)."""
        if tuple(field_shape) == self.field_shape:
            return self
        return WarpField(offsets=resample.resize_corner_aligned(self.offsets, tuple(field_shape)))

    def compose(self, outer: "WarpField") -> "WarpField":
        """First warp by `outer`, then by self: c(u) = outer.o(u) +
        self.o(u + outer.o(u)) (reference WarpMesh::combine); `outer` is
        first resized to self's grid."""
        hm, wm = self.field_shape
        o = outer.resize((hm, wm)).offsets
        yy, xx = _grid_unit((hm, wm), o.device)
        sy = (yy + o[0]) * (hm - 1)
        sx = (xx + o[1]) * (wm - 1)
        inner_at = remap_ops.bilinear_sample(self.offsets, sy, sx, fill=None)
        return WarpField(offsets=o + inner_at)

    # ---- application -------------------------------------------------------

    def sample_map(self, size: tuple[int, int]) -> torch.Tensor:
        """(2, H, W) absolute-pixel backward sample map at frame resolution,
        built on the offsets' device."""
        off = resample.resize_corner_aligned(self.offsets, tuple(size))
        return remap_ops.identity_map(tuple(size), device=off.device) + _to_px(off, size)

    def apply(
        self,
        img: torch.Tensor,
        fill: float | None = 0.0,
        exact_2x2: bool = True,
        filter_mode: str = "easu",
        fmt=None,
    ) -> torch.Tensor:
        """Warp a (C, H, W) / (H, W) image by this field (reference
        WarpMesh::apply, WarpMesh.cpp:183-223).  A 2x2 field takes the
        exact homography path, like the reference (:196-218), unless
        `exact_2x2` is False; any other field warps by its dense sample
        map."""
        size = tuple(img.shape[-2:])
        if exact_2x2 and self.field_shape == (2, 2):
            return self.to_homography(size).warp(img, fill=fill, filter_mode=filter_mode, fmt=fmt)
        return remap_ops.remap(img, self.sample_map(size), fill=fill, filter_mode=filter_mode,
                               fmt=fmt)
