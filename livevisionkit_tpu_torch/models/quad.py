"""Quad: a homography-transformed bounding quad with enclosure tests
(counterpart of livevisionkit_tpu/models/quad.py; reference
Math/BoundingQuad.hpp:27-43, Math/BoundingQuad.cpp).

A frame rectangle pushed through a Homography, with `encloses(point /
rect / quad)` half-plane tests in counter-clockwise order
(BoundingQuad.cpp:71-83): the crop-validity primitive of projective warps.
Vertices are one (4, 2) (x, y) tensor and the sign tests one batched
cross-product reduce, so the test stays on the device.  For mesh warps the
equivalent test is `WarpField.covers`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.models.homography import Homography


@dataclass(frozen=True)
class Quad:
    """Counter-clockwise quad vertices, (4, 2) as (x, y) rows (the
    reference's vertex order, BoundingQuad.cpp:29-34: tl, tr, br, bl of the
    source rect, counter-clockwise in image coordinates where y points
    down)."""

    vertices: torch.Tensor

    @classmethod
    def from_rect(
        cls, size: tuple[float, float], h: Homography | None = None,
        device: torch.device | str = "cuda",
    ) -> "Quad":
        """Quad of the (0, 0)..(w, h) rectangle on `device` (the
        homography's, where one is given), optionally homography-warped
        (reference ctor, BoundingQuad.cpp:27-37)."""
        height, width = size
        dev = device if h is None else h.m.device
        v = torch.tensor([[0.0, 0.0], [width, 0.0], [width, height], [0.0, height]],
                         dtype=torch.float32, device=dev)
        q = cls(vertices=v)
        return q if h is None else q.transform(h)

    def transform(self, h: Homography) -> "Quad":
        return Quad(vertices=h.transform(self.vertices))

    def encloses_points(self, pts_xy: torch.Tensor) -> torch.Tensor:
        """(N,) bool: each point left of or on every edge in CCW order
        (reference sign_2d test, BoundingQuad.cpp:73-83)."""
        a = self.vertices  # (4, 2)
        e = torch.roll(a, -1, dims=0) - a  # (4, 2) edge vectors
        # sign_2d(p, a, b) = cross(p - a, b - a); enclosed iff <= 0 for all.
        d = pts_xy[:, None, :] - a[None, :, :]  # (N, 4, 2)
        cross = d[..., 0] * e[None, :, 1] - d[..., 1] * e[None, :, 0]
        return (cross <= 0.0).all(dim=-1)

    def encloses_rect(self, tl: tuple[float, float], br: tuple[float, float]) -> torch.Tensor:
        """0-d bool: all 4 rect corners enclosed (BoundingQuad.cpp:49-61).
        tl and br as (x, y)."""
        pts = torch.tensor([[tl[0], tl[1]], [br[0], tl[1]], [br[0], br[1]], [tl[0], br[1]]],
                           dtype=torch.float32, device=self.vertices.device)
        return self.encloses_points(pts).all()

    def encloses_quad(self, other: "Quad") -> torch.Tensor:
        return self.encloses_points(other.vertices).all()
