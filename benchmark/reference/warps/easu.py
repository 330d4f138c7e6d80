"""EASU (FidelityFX-SR 1.0 Edge-Adaptive Spatial Upsampling) as a backward
warp through an absolute sample map, in plain PyTorch, frozen here as the
reference of the port's warp (the 12-tap edge-adaptive filter, FSR.cl:93-322,
and its offset-map warp with background fill and a nearest-neighbour ring
just inside the border, FSR.cl:362-403).  The luma is plane 0 (YUV).  Every
operation runs in the dtype of the image it is given.

Tap layout around the sample point (x right, y down), f = floor(sample):
        b c
      e f g h
      i j k l
        n o
"""

from __future__ import annotations

import torch

# (dx, dy) of the 12 taps relative to f, in reference tap order.
TAPS = {
    "b": (0, -1), "c": (1, -1),
    "e": (-1, 0), "f": (0, 0), "g": (1, 0), "h": (2, 0),
    "i": (-1, 1), "j": (0, 1), "k": (1, 1), "l": (2, 1),
    "n": (0, 2), "o": (1, 2),
}


def _dir_terms(la, lb, lc, ld, le):
    """Direction and length from the luma cross (FSR.cl:132-176): a above,
    b left, c centre, d right, e below."""
    dc, cb = ld - lc, lc - lb
    len_x = 1.0 / torch.clamp(torch.maximum(dc.abs(), cb.abs()), min=1e-20)
    dir_x = ld - lb
    len_x = torch.clamp(dir_x.abs() * len_x, 0.0, 1.0) ** 2
    ec, ca = le - lc, lc - la
    len_y = 1.0 / torch.clamp(torch.maximum(ec.abs(), ca.abs()), min=1e-20)
    dir_y = le - la
    len_y = torch.clamp(dir_y.abs() * len_y, 0.0, 1.0) ** 2
    return dir_x, dir_y, len_x + len_y


def _filter(px: dict, ppx: torch.Tensor, ppy: torch.Tensor) -> torch.Tensor:
    """The 12-tap filter on gathered taps (C, ...) at sub-pixel (ppx, ppy)."""
    lum = {k: v[0] for k, v in px.items()}
    dirx = diry = length = torch.zeros_like(ppx)
    corners = (((1 - ppx), (1 - ppy), "befgj"), (ppx, (1 - ppy), "cfghk"),
               ((1 - ppx), ppy, "fijkn"), (ppx, ppy, "gjklo"))
    for wx, wy, (a, b, c, d, e) in corners:
        w = wx * wy
        dx, dy, lv = _dir_terms(lum[a], lum[b], lum[c], lum[d], lum[e])
        dirx, diry, length = dirx + dx * w, diry + dy * w, length + lv * w

    dir_r = dirx * dirx + diry * diry
    zro = dir_r < (1.0 / 32768.0)
    inv_r = torch.where(zro, 1.0, torch.rsqrt(torch.clamp(dir_r, min=1e-30)))
    dirx = torch.where(zro, 1.0, dirx) * inv_r
    diry = torch.where(zro, 0.0, diry) * inv_r
    length = (length * 0.5) ** 2
    stretch = (dirx * dirx + diry * diry) / torch.clamp(torch.maximum(dirx.abs(), diry.abs()), min=1e-20)
    len2x = 1.0 + (stretch - 1.0) * length
    len2y = 1.0 - 0.5 * length
    lob = 0.5 + ((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = 1.0 / lob
    lob2 = lob * lob
    cw1, cw2 = -1.25 - 2.0 * lob, 0.25 + 2.5 * lob + lob2
    cw3, cw4 = -0.5 * lob - 1.25 * lob2, 0.25 * lob2
    dxx, dyx, dxy, dyy = dirx * len2x, diry * len2x, -diry * len2y, dirx * len2y

    mi4 = torch.minimum(torch.minimum(px["f"], px["g"]), torch.minimum(px["j"], px["k"]))
    ma4 = torch.maximum(torch.maximum(px["f"], px["g"]), torch.maximum(px["j"], px["k"]))
    ac = torch.zeros_like(px["f"])
    aw = torch.zeros_like(ppx)
    for letter, (dx, dy) in TAPS.items():
        offx, offy = dx - ppx, dy - ppy
        vx = offx * dxx + offy * dyx
        vy = offx * dxy + offy * dyy
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        w = 1.0 + d2 * (cw1 + d2 * (cw2 + d2 * (cw3 + d2 * cw4)))
        ac = ac + px[letter] * w
        aw = aw + w
    out = ac * (1.0 / torch.where(aw.abs() > 1e-20, aw, 1e-20))
    return torch.minimum(torch.maximum(out, mi4), ma4)


def remap(img: torch.Tensor, sample_map: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Warp (C, H, W) through the (2, H', W') absolute (y, x) map: EASU where
    the 4x4 support lies inside, the nearest pixel on the ring just inside
    the border, `fill` outside."""
    c, h, w = img.shape
    ys, xs = sample_map[0], sample_map[1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ppy, ppx = ys - y0, xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    flat = img.reshape(c, h * w)
    px = {}
    for letter, (dx, dy) in TAPS.items():
        yc = torch.clamp(y0i + dy, 0, h - 1)
        xc = torch.clamp(x0i + dx, 0, w - 1)
        px[letter] = flat[:, yc * w + xc]
    val = _filter(px, ppx, ppy)
    easu_ok = (x0i >= 1) & (y0i >= 1) & (x0i < w - 4) & (y0i < h - 4)
    inside = (x0i >= 0) & (y0i >= 0) & (x0i < w) & (y0i < h)
    return torch.where(easu_ok, val, torch.where(inside, px["f"], fill))
