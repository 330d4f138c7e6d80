"""How a program's output frame is judged against the reference's inside a
region of it (each plane's clear region of a two-plane scene): the fit of
`reference.compare.judge`, made over the region's pixels alone.

Inside the region the program's frame O is fitted as the reference's R
displaced by an affine field d over the region's bounding box: O(u) ~ R(u)
+ grad R(u) . d(u), by least squares over every plane.  `misalign_px` is
the largest |d| at the bounding box's corners, `residual_u8` the mean
|O - R - grad R . d| over the region in 8-bit levels, as `compare.judge`
reads them over its interior.
"""

from __future__ import annotations

import torch


def judge_region(prog: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor) -> tuple[float, float]:
    """(misalign_px, residual_u8) of one (C, H, W) output against the
    reference's, both float32 on one device, over the (H, W) bool `mask`
    (NaN for both where it is empty)."""
    ys, xs = torch.nonzero(mask, as_tuple=True)
    if ys.numel() == 0:
        return float("nan"), float("nan")
    gy = torch.zeros_like(ref)
    gx = torch.zeros_like(ref)
    gy[:, 1:-1] = 0.5 * (ref[:, 2:] - ref[:, :-2])
    gx[:, :, 1:-1] = 0.5 * (ref[:, :, 2:] - ref[:, :, :-2])
    e, gy, gx = (prog - ref)[:, ys, xs], gy[:, ys, xs], gx[:, ys, xs]
    y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
    yn = (2.0 * (ys - y0) / torch.clamp(y1 - y0, min=1) - 1.0).float()
    xn = (2.0 * (xs - x0) / torch.clamp(x1 - x0, min=1) - 1.0).float()
    a = torch.zeros((6, 6), dtype=torch.float64, device=e.device)
    b = torch.zeros(6, dtype=torch.float64, device=e.device)
    for c in range(e.shape[0]):
        j = torch.stack([gx[c], gx[c] * xn, gx[c] * yn, gy[c], gy[c] * xn, gy[c] * yn]).double()
        a += j @ j.T
        b += j @ e[c].double()
    p = torch.linalg.solve(a + 1e-12 * torch.eye(6, dtype=torch.float64, device=e.device), b)
    corners = torch.tensor([[1.0, sx, sy] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)],
                           dtype=torch.float64, device=e.device)
    dx, dy = corners @ p[:3], corners @ p[3:]
    misalign = float(torch.sqrt(dx * dx + dy * dy).max())
    pf = p.float()
    fit = gx * (pf[0] + pf[1] * xn + pf[2] * yn) + gy * (pf[3] + pf[4] * xn + pf[5] * yn)
    residual = float((e - fit).abs().mean()) * 255.0
    return misalign, residual
