"""Homography: 3x3 projective transform (counterpart of
livevisionkit_tpu/models/homography.py; reference Math/Homography.hpp).

Point convention: points are (..., 2) tensors ordered (x, y); sample maps
for remap are (2, H, W) ordered (y, x) — conversion happens only in
`sample_map`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.ops import remap as remap_ops


def dlt4(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched exact 4-point DLT: (..., 4, 2) x2 -> (..., 3, 3).

    The 8x8 system (h33 = 1) is eliminated by an unrolled, partially
    pivoted Gauss-Jordan that vectorizes over any batch (the same steps as
    the JAX version, so the RANSAC hypotheses agree).  Points are pre-scaled
    to O(1); degenerate quads produce non-finite matrices, which callers
    mask (RANSAC scores them -inf).
    """
    batch = src.shape[:-2]
    c = 1.0 / 256.0  # fixed conditioning scale (detection-res coords)
    ps = src * c
    qs = dst * c
    x, y = ps[..., 0], ps[..., 1]  # (..., 4)
    u, v = qs[..., 0], qs[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    ru = torch.stack([x, y, o, z, z, z, -u * x, -u * y, u], dim=-1)
    rv = torch.stack([z, z, z, x, y, o, -v * x, -v * y, v], dim=-1)
    aug = torch.cat([ru, rv], dim=-2)  # (..., 8, 9) augmented [A | b]
    idx8 = torch.arange(8, device=src.device)
    for k in range(8):
        col = aug[..., :, k].abs()
        col = torch.where(idx8 >= k, col, float("-inf"))
        r = torch.argmax(col, dim=-1, keepdim=True)  # (..., 1) first maximum
        perm = torch.where(idx8 == k, r, torch.where(idx8 == r, k, idx8))
        aug = torch.gather(aug, -2, perm[..., None].expand(aug.shape))
        piv = aug[..., k, k][..., None]  # (..., 1)
        inv = torch.where(piv.abs() > 1e-12, 1.0 / piv, float("nan"))
        row = aug[..., k, :] * inv  # (..., 9) normalized pivot row
        fac = aug[..., :, k][..., None]  # (..., 8, 1)
        aug = aug - fac * row[..., None, :]
        aug[..., k, :] = row  # `aug` is a fresh tensor: in-place is local
    h8 = aug[..., 8]
    m = torch.cat([h8, torch.ones(batch + (1,), dtype=h8.dtype, device=h8.device)], dim=-1)
    m = m.reshape(batch + (3, 3))
    # Undo the conditioning scale: H = S^-1 Hn S, S = diag(c, c, 1), i.e.
    # entry (i, j) times s_j / s_i (exact: c is a power of two).  Built on
    # the device: a table from host values would be a synchronizing copy.
    s = torch.cat([torch.full((2,), c, dtype=m.dtype, device=m.device),
                   torch.ones(1, dtype=m.dtype, device=m.device)])
    return m * (s[None, :] / s[:, None])


def _adjugate(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of a (3, 3) matrix (= inverse * determinant)."""
    return torch.stack([
        torch.stack([m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1], m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2], m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]]),
        torch.stack([m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2], m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0], m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]]),
        torch.stack([m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0], m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1], m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]]),
    ])


@dataclass(frozen=True)
class Homography:
    m: torch.Tensor  # (3, 3) float32

    @classmethod
    def identity(cls, device: torch.device | str = "cuda") -> "Homography":
        return cls(m=torch.eye(3, dtype=torch.float32, device=device))

    @classmethod
    def from_matrix(cls, m) -> "Homography":
        """From a (3, 3) matrix: a tensor (kept on its device) or an array."""
        return cls(m=torch.as_tensor(m).to(torch.float32))

    @classmethod
    def from_affine(cls, a) -> "Homography":
        """From a (2, 3) affine matrix, a tensor (kept on its device) or an
        array (reference Homography::FromAffineMatrix, Math/Homography.cpp).
        The bottom row is built on the device, not copied from the host."""
        a = torch.as_tensor(a).to(torch.float32)
        return cls(m=torch.cat([a, torch.eye(3, dtype=torch.float32, device=a.device)[2:]]))

    @classmethod
    def from_similarity(cls, scale, angle, tx, ty) -> "Homography":
        """Similarity transform: scale * R(angle) + translation; arguments
        are 0-d float32 tensors on one device."""
        c = scale * torch.cos(angle)
        s = scale * torch.sin(angle)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        return cls(m=torch.stack([
            torch.stack([c, -s, tx]),
            torch.stack([s, c, ty]),
            torch.stack([zero, zero, one]),
        ]))

    @classmethod
    def from_quad(cls, src: torch.Tensor, dst: torch.Tensor) -> "Homography":
        """Exact homography mapping 4 src points to 4 dst points, (4, 2) each."""
        return cls(m=dlt4(src, dst))

    def __matmul__(self, other: "Homography") -> "Homography":
        """Composition: (self @ other)(p) == self(other(p))."""
        return Homography(m=self.m @ other.m)

    def inverse(self) -> "Homography":
        """Closed-form adjugate inverse, normalized so [2, 2] ~ 1."""
        adj = _adjugate(self.m)
        s = adj[2, 2]
        scale = torch.where(s.abs() > 1e-12, 1.0 / s, 1.0)
        return Homography(m=adj * scale)

    def normalized(self) -> "Homography":
        """Scaled so m[2, 2] == 1 (the projective scale ambiguity)."""
        return Homography(m=self.m / self.m[2, 2])

    def transform(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform (..., 2) (x, y) points."""
        ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype, device=pts.device)
        out = torch.cat([pts, ones], dim=-1) @ self.m.to(pts.dtype).T
        return out[..., :2] / out[..., 2:3]

    def sample_map(self, size: tuple[int, int], inverse: bool = True) -> torch.Tensor:
        """(2, H, W) backward sample map such that remap(img, map) warps img
        by this homography: output(u) = input(H^-1 u) (cv::warpPerspective).
        With inverse=False it samples at H(u) directly."""
        h, w = size
        m = (self.inverse() if inverse else self).m.to(torch.float32)
        dev = m.device
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        den = m[2, 0] * xx + m[2, 1] * yy + m[2, 2]
        sx = (m[0, 0] * xx + m[0, 1] * yy + m[0, 2]) / den
        sy = (m[1, 0] * xx + m[1, 1] * yy + m[1, 2]) / den
        return torch.stack([sy, sx])

    def warp(
        self,
        img: torch.Tensor,
        fill: float | None = 0.0,
        filter_mode: str = "easu",
        fmt=None,
    ) -> torch.Tensor:
        """Warp a (C, H, W) or (H, W) image by this homography (EASU by
        default, like the reference's homography warp)."""
        return remap_ops.remap(
            img, self.sample_map(img.shape[-2:]), fill=fill,
            filter_mode=filter_mode, fmt=fmt,
        )
