"""Chessboard corner detection for camera calibration (counterpart of
livevisionkit_tpu/vision/chessboard.py).

Reference parity: cv::findChessboardCorners + cornerSubPix as used by
CameraCalibrator::feed (reference Vision/CameraCalibrator.cpp:49-67) and the
CCTool capture loop (reference Modules/OBS-Plugin/Sources/Tools/CCTool
.cpp:30-35: 9x6 board, 25 captures).

The dense response runs as torch ops on the frame's device (a ChESS-style
ring detector: at an X-corner a radius-sampled intensity ring alternates
dark/bright twice, so the magnitude of its 2nd circular harmonic
dominates), while the sparse ordering of detected corners into board
rows/columns is host-side numpy and scipy, as in the JAX package:
calibration is an offline tool.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.ops import resample

# Radius-5 ring, 16 samples (dy, dx) — ChESS sampling pattern.
_RING5 = [
    (-5, 0), (-5, 2), (-4, 4), (-2, 5), (0, 5), (2, 5), (4, 4), (5, 2),
    (5, 0), (5, -2), (4, -4), (2, -5), (0, -5), (-2, -5), (-4, -4), (-5, -2),
]


def chess_response(gray: torch.Tensor) -> torch.Tensor:
    """Dense X-corner response (>= 0). gray: (H, W) in [0, 1]."""
    g = resample.gaussian_blur5(gray)
    h, w = g.shape
    pad = 5
    p = F.pad(g[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    ring = torch.stack(
        [p[pad + dy : pad + dy + h, pad + dx : pad + dx + w] for dy, dx in _RING5]
    )  # (16, H, W)
    n = len(_RING5)
    ang = 2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=g.device) / n
    # Circular harmonics of the ring.
    c2 = torch.tensordot(torch.cos(2 * ang).to(g.dtype), ring, dims=([0], [0]))
    s2 = torch.tensordot(torch.sin(2 * ang).to(g.dtype), ring, dims=([0], [0]))
    c1 = torch.tensordot(torch.cos(ang).to(g.dtype), ring, dims=([0], [0]))
    s1 = torch.tensordot(torch.sin(ang).to(g.dtype), ring, dims=([0], [0]))
    h2 = torch.sqrt(c2 * c2 + s2 * s2)  # X-corner energy
    h1 = torch.sqrt(c1 * c1 + s1 * s1)  # edge energy (suppress)
    mean_dev = (ring - ring.mean(dim=0)).abs().mean(dim=0)
    resp = h2 - h1 - mean_dev * 0.5
    return torch.clamp(resp, min=0.0)


def _subpixel_refine(resp: np.ndarray, y: int, x: int) -> tuple[float, float]:
    """Quadratic peak interpolation on the response map."""
    h, w = resp.shape
    if not (1 <= y < h - 1 and 1 <= x < w - 1):
        return float(y), float(x)

    def parab(m, c, p):
        den = m - 2 * c + p
        return 0.0 if abs(den) < 1e-12 else 0.5 * (m - p) / den

    dy = parab(resp[y - 1, x], resp[y, x], resp[y + 1, x])
    dx = parab(resp[y, x - 1], resp[y, x], resp[y, x + 1])
    return y + np.clip(dy, -0.5, 0.5), x + np.clip(dx, -0.5, 0.5)


def find_chessboard(
    gray: np.ndarray | torch.Tensor,
    pattern: tuple[int, int] = (9, 6),
    min_response: float = 0.05,
) -> np.ndarray | None:
    """Detect an ordered (cols*rows, 2) grid of inner chessboard corners
    (x, y), row-major like OpenCV, or None if the board is not found.

    pattern: (cols, rows) of INNER corners.  A tensor `gray` is read on its
    own device (the response runs there); a numpy one on the CPU.
    """
    cols, rows = pattern
    want = cols * rows
    g = torch.as_tensor(gray, dtype=torch.float32)
    resp = chess_response(g).cpu().numpy()
    h, w = resp.shape

    # Non-maximum suppression over 5x5.
    from scipy import ndimage  # scipy ships with the image

    maxf = ndimage.maximum_filter(resp, size=5)
    peaks = (resp == maxf) & (resp > min_response)
    ys, xs = np.nonzero(peaks)
    if len(ys) < want:
        return None
    order = np.argsort(resp[ys, xs])[::-1][: want * 3]
    pts = np.stack([xs[order], ys[order]], -1).astype(np.float64)
    scores = resp[ys, xs][order]

    grid = _order_grid(pts, cols, rows, scores)
    if grid is None:
        return None
    out = []
    for gx, gy in grid:
        ry, rx = _subpixel_refine(resp, int(round(gy)), int(round(gx)))
        out.append([rx, ry])
    return np.asarray(out)


def _order_grid(
    pts: np.ndarray, cols: int, rows: int, scores: np.ndarray | None = None
) -> np.ndarray | None:
    """Order candidate points into a cols x rows lattice by BFS walking the
    local neighbour structure.  The lattice basis is re-estimated at every
    step (from the actual vector to the found neighbour), so perspective and
    lens distortion are tolerated — the same idea that makes OpenCV's
    findChessboardCorners robust on tilted boards."""
    from scipy.spatial import cKDTree

    want = cols * rows
    if len(pts) < want:
        return None
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=2)
    pitch = np.median(d[:, 1])
    if not np.isfinite(pitch) or pitch <= 2:
        return None

    def nearest_within(pos, tol):
        dd, ii = tree.query(pos)
        return int(ii) if dd < tol else None

    # Seed at the point closest to the cloud centroid.
    seed = int(np.argmin(np.linalg.norm(pts - pts.mean(0), axis=1)))
    nb_d, nb_i = tree.query(pts[seed], k=min(7, len(pts)))
    b1 = pts[nb_i[1]] - pts[seed]
    b2 = None
    for j in nb_i[2:]:
        v = pts[j] - pts[seed]
        cosang = abs(v @ b1) / (np.linalg.norm(v) * np.linalg.norm(b1) + 1e-12)
        if cosang < 0.4 and 0.6 < np.linalg.norm(v) / np.linalg.norm(b1) < 1.7:
            b2 = v
            break
    if b2 is None:
        return None

    coords: dict[int, tuple[int, int]] = {seed: (0, 0)}
    basis: dict[int, tuple[np.ndarray, np.ndarray]] = {seed: (b1, b2)}
    queue = [seed]
    while queue:
        i = queue.pop(0)
        ci = np.array(coords[i])
        bb1, bb2 = basis[i]
        for step, delta in (
            (bb1, (1, 0)), (-bb1, (-1, 0)), (bb2, (0, 1)), (-bb2, (0, -1))
        ):
            j = nearest_within(pts[i] + step, 0.35 * np.linalg.norm(step))
            if j is None or j in coords:
                continue
            coords[j] = tuple(ci + delta)
            # Local basis update: the step we actually took, other axis kept.
            actual = pts[j] - pts[i]
            if abs(delta[0]):
                basis[j] = (actual * delta[0], bb2)
            else:
                basis[j] = (bb1, actual * delta[1])
            queue.append(j)

    if len(coords) < want:
        return None
    if scores is None:
        scores = np.ones(len(pts))
    by_cell = {c: i for i, c in coords.items()}
    us = [c[0] for c in by_cell]
    vs = [c[1] for c in by_cell]
    # Among all fully-populated cols x rows windows, keep the one with the
    # strongest summed corner response: inner corners respond much harder
    # than board-boundary corners, so this rejects off-by-one windows.
    best, best_score = None, -np.inf
    for cu, cv, transpose in ((cols, rows, False), (rows, cols, True)):
        for bu in range(min(us), max(us) - cu + 2):
            for bv in range(min(vs), max(vs) - cv + 2):
                idx = [
                    by_cell.get((bu + a, bv + b))
                    for b in range(cv)
                    for a in range(cu)
                ]
                if not all(i is not None for i in idx):
                    continue
                score = float(scores[np.asarray(idx)].sum())
                if score > best_score:
                    grid = pts[np.asarray(idx)].reshape(cv, cu, 2)
                    if transpose:
                        grid = grid.transpose(1, 0, 2)[:, ::-1]
                        grid = grid.reshape(rows, cols, 2)
                    best, best_score = grid.reshape(-1, 2), score
    return best
