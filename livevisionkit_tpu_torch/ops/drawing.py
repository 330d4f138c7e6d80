"""Debug drawing: grids, points, crosses, rectangles on device frames
(counterpart of livevisionkit_tpu/ops/drawing.py).

Reference parity: the GPU overlay kernels ``grid``/``points``/``crosses``
(Functions/OpenCL/Sources/Drawing.cl:22,43,73) and the per-format colour
tables (Functions/Drawing.hpp:22-124), used by the filters' test modes
(StabilizationFilter.cpp:163-188).

Each overlay is a dense (H, W) mask, 0 or 1, blended into the (C, H, W)
planes in one pass.  Point overlays scatter into the mask with one
`scatter_reduce(..., "amax")` over flat indices (JAX's `.at[].max`), so
nothing is read back to the host; colours are Python floats, so no small
tensor is copied to the device either.
"""

from __future__ import annotations

import numpy as np
import torch

from livevisionkit_tpu_torch.types import PixelFormat

# Colour constants per format (reference Drawing.hpp YUV/BGR tables).
_COLOURS_RGB = {
    "red": (1.0, 0.1, 0.1),
    "green": (0.1, 1.0, 0.1),
    "blue": (0.15, 0.3, 1.0),
    "yellow": (1.0, 0.9, 0.1),
    "magenta": (1.0, 0.1, 1.0),
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
}


def colour(name: str, fmt: PixelFormat) -> tuple[float, ...]:
    """The named colour's value per channel of `fmt`, rounded to float32."""
    r, g, b = _COLOURS_RGB[name]
    if fmt in (PixelFormat.RGB, PixelFormat.UNKNOWN):
        col = (r, g, b)
    elif fmt is PixelFormat.BGR:
        col = (b, g, r)
    else:
        y = 0.299 * r + 0.587 * g + 0.114 * b
        # YUV: BT.601 full range, like ops/color.py.
        col = (y,) if fmt is PixelFormat.GRAY else (y, 0.492 * (b - y) + 0.5, 0.877 * (r - y) + 0.5)
    return tuple(float(v) for v in np.asarray(col, np.float32))


def _blend(img: torch.Tensor, mask: torch.Tensor, col: tuple[float, ...]) -> torch.Tensor:
    """Blend colour into (C, H, W) planes where the (H, W) mask is set."""
    keep = 1.0 - mask
    return torch.stack([img[c] * keep + col[c] * mask for c in range(img.shape[0])])


def _iota(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return yy, xx


def draw_grid(img: torch.Tensor, grid_shape: tuple[int, int], col: tuple[float, ...],
              thickness: int = 1) -> torch.Tensor:
    """Overlay a corner-aligned grid (reference Drawing.cl `grid` kernel)."""
    _, h, w = img.shape
    gy, gx = grid_shape
    yy, xx = _iota(h, w, img.device)
    py, px = (h - 1) / (gy - 1), (w - 1) / (gx - 1)
    dy = (torch.remainder(yy + py / 2, py) - py / 2).abs()
    dx = (torch.remainder(xx + px / 2, px) - px / 2).abs()
    mask = ((dy < thickness) | (dx < thickness)).to(img.dtype)
    return _blend(img, mask, col)


def _scatter_hits(img: torch.Tensor, ys: list, xs: list, vals: torch.Tensor) -> torch.Tensor:
    """(H, W) mask: the max of `vals` over the (ys[k], xs[k]) pixels each
    point touches, 0 elsewhere."""
    _, h, w = img.shape
    idx = torch.cat([y * w + x for y, x in zip(ys, xs)])
    hits = torch.zeros(h * w, dtype=img.dtype, device=img.device)
    return hits.scatter_reduce(0, idx, vals.repeat(len(ys)), "amax").reshape(h, w)


def _pixel_coords(img: torch.Tensor, points: torch.Tensor):
    _, h, w = img.shape
    xi = torch.clamp(points[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(points[:, 1].to(torch.int64), 0, h - 1)
    return yi, xi


def draw_points(img: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                col: tuple[float, ...], radius: int = 2) -> torch.Tensor:
    """Filled squares at (N, 2) (x, y) points where `valid` (reference
    `points` kernel)."""
    _, h, w = img.shape
    yi, xi = _pixel_coords(img, points)
    offsets = [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)]
    ys = [torch.clamp(yi + dy, 0, h - 1) for dy, _ in offsets]
    xs = [torch.clamp(xi + dx, 0, w - 1) for _, dx in offsets]
    return _blend(img, _scatter_hits(img, ys, xs, valid.to(img.dtype)), col)


def draw_crosses(img: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                 col: tuple[float, ...], radius: int = 3) -> torch.Tensor:
    """+-shaped crosses at (N, 2) (x, y) points where `valid` (reference
    `crosses` kernel)."""
    _, h, w = img.shape
    yi, xi = _pixel_coords(img, points)
    ys, xs = [], []
    for d in range(-radius, radius + 1):
        ys += [torch.clamp(yi + d, 0, h - 1), yi]
        xs += [xi, torch.clamp(xi + d, 0, w - 1)]
    return _blend(img, _scatter_hits(img, ys, xs, valid.to(img.dtype)), col)


def draw_rect(img: torch.Tensor, top_left: tuple[float, float], bottom_right: tuple[float, float],
              col: tuple[float, ...], thickness: int = 2) -> torch.Tensor:
    """Rectangle outline; corners (x, y) as fractions of the frame (e.g. the
    stabilizer's stable region)."""
    _, h, w = img.shape
    x0, y0 = top_left[0] * (w - 1), top_left[1] * (h - 1)
    x1, y1 = bottom_right[0] * (w - 1), bottom_right[1] * (h - 1)
    yy, xx = _iota(h, w, img.device)
    inside = (yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)
    core = ((yy >= y0 + thickness) & (yy <= y1 - thickness)
            & (xx >= x0 + thickness) & (xx <= x1 - thickness))
    return _blend(img, (inside & ~core).to(img.dtype), col)


def draw_motion_field(img: torch.Tensor, offsets: torch.Tensor, col: tuple[float, ...],
                      scale: float = 1.0) -> torch.Tensor:
    """A WarpField's (2, Hm, Wm) normalized offsets as crosses at its grid
    nodes moved by the motion (StabilizationFilter.cpp:163-188)."""
    _, h, w = img.shape
    _, hm, wm = offsets.shape
    gy, gx = _iota(hm, wm, img.device)
    py = gy * ((h - 1) / (hm - 1)) + offsets[0] * (h - 1) * scale
    px = gx * ((w - 1) / (wm - 1)) + offsets[1] * (w - 1) * scale
    pts = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    return draw_crosses(img, pts, torch.ones(pts.shape[0], dtype=torch.bool, device=img.device), col)
