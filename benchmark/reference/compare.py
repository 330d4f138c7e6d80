"""How a program's output frame is judged against the reference's.

Inside a margin (where neither side's border fill reaches), the program's
frame O is fitted as the reference's R displaced by an affine field d:
O(u) ~ R(u) + grad R(u) . d(u), by least squares over every plane.  Two
numbers come out:

  misalign_px   the largest |d| at the interior's corners: how far the
                program's geometry (its motion estimate, the smoother's
                correction, the warp's map) puts the picture from where
                the true path puts it;
  residual_u8   the mean |O - R - grad R . d| in 8-bit levels: what the
                geometry does not explain (the warp's filter, the 8-bit
                queue, the deblocker, CAS, a colour conversion, a wrong
                frame).

Where the chain has filters after the stabilizer, each one's change to the
frame it was given (its reference output minus its reference input, a
`stage`) joins the fit as one more column: O(u) ~ R(u) + grad R . d(u) +
sum_k a_k D_k(u).  `a_k` reads 0 where the program made the stage's change
as the reference did, -1 where it left the stage out, +1 where it made the
change twice; the stage's gap is |a_k|.  One more column, the reference's
Laplacian, takes up the difference in blur that the warp's interpolation
makes where the program samples the source at other sub-pixel phases than
the reference (its tracker's error), which would otherwise read as a
sharpening stage's change.  These columns are fitted with the geometry but
leave the two numbers above as they were.
"""

from __future__ import annotations

import torch


def judge(prog: torch.Tensor, ref: torch.Tensor, margin: int,
          stages: dict | None = None) -> tuple[float, float, dict]:
    """(misalign_px, residual_u8, {stage: gap}) of one (C, H, W) output
    against the reference's, both float32 on one device; `stages` maps a
    stage's name to its change D_k (C, H, W)."""
    _, h, w = ref.shape
    gy = torch.zeros_like(ref)
    gx = torch.zeros_like(ref)
    gy[:, 1:-1] = 0.5 * (ref[:, 2:] - ref[:, :-2])
    gx[:, :, 1:-1] = 0.5 * (ref[:, :, 2:] - ref[:, :, :-2])
    sl = (slice(None), slice(margin, h - margin), slice(margin, w - margin))
    e, gy, gx = (prog - ref)[sl], gy[sl], gx[sl]
    ih, iw = e.shape[-2:]
    yn = torch.linspace(-1.0, 1.0, ih, device=e.device)[:, None].expand(ih, iw)
    xn = torch.linspace(-1.0, 1.0, iw, device=e.device)[None, :].expand(ih, iw)
    names = sorted(stages or {})
    deltas = [stages[k][sl] for k in names]
    lap = torch.zeros_like(ref)
    lap[:, 1:-1, 1:-1] = (ref[:, 2:, 1:-1] + ref[:, :-2, 1:-1] + ref[:, 1:-1, 2:] + ref[:, 1:-1, :-2]
                          - 4.0 * ref[:, 1:-1, 1:-1])
    lap = lap[sl]
    n = 6 + len(names) + (1 if names else 0)
    a = torch.zeros((n, n), dtype=torch.float64, device=e.device)
    b = torch.zeros(n, dtype=torch.float64, device=e.device)
    for c in range(e.shape[0]):
        cols = [gx[c], gx[c] * xn, gx[c] * yn, gy[c], gy[c] * xn, gy[c] * yn] + [d[c] for d in deltas]
        if names:
            cols.append(lap[c])
        j = torch.stack(cols).reshape(n, -1).double()
        a += j @ j.T
        b += j @ e[c].reshape(-1).double()
    eye = 1e-12 * torch.eye(6, dtype=torch.float64, device=e.device)
    p = torch.linalg.solve(a[:6, :6] + eye, b[:6])
    gaps = {}
    if names:
        q = torch.linalg.solve(a + 1e-12 * torch.eye(n, dtype=torch.float64, device=e.device), b)
        gaps = {k: abs(float(q[6 + i])) for i, k in enumerate(names)}
    corners = torch.tensor([[1.0, sx, sy] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)],
                           dtype=torch.float64, device=e.device)
    dx, dy = corners @ p[:3], corners @ p[3:]
    misalign = float(torch.sqrt(dx * dx + dy * dy).max())
    pf = p.float()
    fit = (gx * (pf[0] + pf[1] * xn + pf[2] * yn) + gy * (pf[3] + pf[4] * xn + pf[5] * yn))
    residual = float((e - fit).abs().mean()) * 255.0
    return misalign, residual, gaps
