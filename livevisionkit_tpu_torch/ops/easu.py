"""EASU: FidelityFX-SR 1.0 Edge-Adaptive Spatial Upsampling, as plain
PyTorch ops (counterpart of livevisionkit_tpu/ops/easu.py): the offset-map
warp `easu_remap` and the upscale `easu_scale`.

Reference parity: the 12-tap edge-adaptive filter `easu` (FSR.cl:93-322),
the upscale `easu_scale` (:324-358) and the offset-map warp `easu_remap`
(:362-403) with background fill and a nearest-neighbour ring just inside
the border (:385-397).  These are the plain versions of the warp kernel
(csrc/warp.cu) and the scale kernel (csrc/easu_scale.cu), which evaluate
the same math per output pixel (csrc/easu.cuh); the approximate rcp/rsqrt
of the reference are exact here.

Tap layout around the sample point (x right, y down), f = floor(sample):
        b c
      e f g h
      i j k l
        n o
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import easu_scale as easu_scale_kernel
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils.batching import stream_first

# (dx, dy) of the 12 taps relative to f, in reference tap order.
_TAPS = {
    "b": (0, -1), "c": (1, -1),
    "e": (-1, 0), "f": (0, 0), "g": (1, 0), "h": (2, 0),
    "i": (-1, 1), "j": (0, 1), "k": (1, 1), "l": (2, 1),
    "n": (0, 2), "o": (1, 2),
}


def _luma(px: dict[str, torch.Tensor], fmt: PixelFormat) -> dict[str, torch.Tensor]:
    """2x-luma per tap (FSR.cl:286-297): plane 0 for YUV/GRAY, else
    0.5*ch0 + ch1 + 0.5*ch2."""
    if fmt in (PixelFormat.YUV, PixelFormat.GRAY):
        return {k: v[0] for k, v in px.items()}
    return {k: 0.5 * v[0] + v[1] + 0.5 * v[2] for k, v in px.items()}


def _dir_terms(la, lb, lc, ld, le):
    """Direction/length terms from the 4-neighbour luma cross (FSR.cl:132-176):
    a=above, b=left, c=center, d=right, e=below.  Returns (dir_x, dir_y,
    len_x + len_y)."""
    dc = ld - lc
    cb = lc - lb
    len_x = 1.0 / torch.clamp(torch.maximum(dc.abs(), cb.abs()), min=1e-20)
    dir_x = ld - lb
    len_x = torch.clamp(dir_x.abs() * len_x, 0.0, 1.0) ** 2
    ec = le - lc
    ca = lc - la
    len_y = 1.0 / torch.clamp(torch.maximum(ec.abs(), ca.abs()), min=1e-20)
    dir_y = le - la
    len_y = torch.clamp(dir_y.abs() * len_y, 0.0, 1.0) ** 2
    return dir_x, dir_y, len_x + len_y


def _accumulate(dirx, diry, length, wx, wy, la, lb, lc, ld, le):
    """Direction/length accumulation for one bilinear corner
    (easu_accumulate, FSR.cl:132-176)."""
    w = wx * wy
    dir_x, dir_y, lenv = _dir_terms(la, lb, lc, ld, le)
    return dirx + dir_x * w, diry + dir_y * w, length + lenv * w


def _easu_core(
    px: dict[str, torch.Tensor], ppx: torch.Tensor, ppy: torch.Tensor, fmt: PixelFormat
) -> torch.Tensor:
    """The 12-tap EASU filter given gathered taps and sub-pixel position.

    px: tap letter -> (C, ...) values; ppx/ppy: (...) fractional offsets.
    Returns (C, ...) filtered pixels.
    """
    lum = _luma(px, fmt)
    zero = torch.zeros_like(ppx)
    dirx, diry, length = zero, zero, zero
    # Four bilinear corners f, g, j, k (FSR.cl:300-304).
    dirx, diry, length = _accumulate(
        dirx, diry, length, 1 - ppx, 1 - ppy,
        lum["b"], lum["e"], lum["f"], lum["g"], lum["j"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, ppx, 1 - ppy,
        lum["c"], lum["f"], lum["g"], lum["h"], lum["k"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, 1 - ppx, ppy,
        lum["f"], lum["i"], lum["j"], lum["k"], lum["n"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, ppx, ppy,
        lum["g"], lum["j"], lum["k"], lum["l"], lum["o"])
    return _easu_filter(px, dirx, diry, length, ppx, ppy)


def _shape_kernel(dirx, diry, length):
    """Direction normalization + kernel shaping (FSR.cl:306-330).

    Returns (dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4): the rotated-
    distance factors and the Horner coefficients of the quartic tap weight
    1 + d2*(cw1 + d2*(cw2 + d2*(cw3 + d2*cw4))), d2 = min(vx^2 + vy^2, clp)."""
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < (1.0 / 32768.0)
    inv_r = torch.rsqrt(torch.clamp(dir_r, min=1e-30))
    inv_r = torch.where(zro, 1.0, inv_r)
    dirx = torch.where(zro, 1.0, dirx) * inv_r
    diry = torch.where(zro, 0.0, diry) * inv_r

    length = (length * 0.5) ** 2
    stretch = (dirx * dirx + diry * diry) / torch.clamp(
        torch.maximum(dirx.abs(), diry.abs()), min=1e-20
    )
    len2x = 1.0 + (stretch - 1.0) * length
    len2y = 1.0 - 0.5 * length
    lob = 0.5 + ((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = 1.0 / lob
    lob2 = lob * lob
    cw1 = -1.25 - 2.0 * lob
    cw2 = 0.25 + 2.5 * lob + lob2
    cw3 = -0.5 * lob - 1.25 * lob2
    cw4 = 0.25 * lob2
    dxx = dirx * len2x
    dyx = diry * len2x
    dxy = -diry * len2y
    dyy = dirx * len2y
    return dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4


def _easu_filter(px, dirx, diry, length, ppx, ppy) -> torch.Tensor:
    """Kernel shaping + 12 weighted taps + de-ring (FSR.cl:306-322,100-127)."""
    dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4 = _shape_kernel(dirx, diry, length)

    # De-ringing window: min/max of the 4 nearest (f, g, j, k).
    mi4 = torch.minimum(torch.minimum(px["f"], px["g"]), torch.minimum(px["j"], px["k"]))
    ma4 = torch.maximum(torch.maximum(px["f"], px["g"]), torch.maximum(px["j"], px["k"]))

    ac = torch.zeros_like(px["f"])
    aw = torch.zeros_like(ppx)
    for letter, (dx, dy) in _TAPS.items():
        offx = dx - ppx
        offy = dy - ppy
        vx = offx * dxx + offy * dyx
        vy = offx * dxy + offy * dyy
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        w = 1.0 + d2 * (cw1 + d2 * (cw2 + d2 * (cw3 + d2 * cw4)))
        ac = ac + px[letter] * w
        aw = aw + w

    out = ac * (1.0 / torch.where(aw.abs() > 1e-20, aw, 1e-20))
    return torch.minimum(torch.maximum(out, mi4), ma4)


def easu_remap(
    img: torch.Tensor,
    sample_map: torch.Tensor,
    fmt: PixelFormat = PixelFormat.YUV,
    fill: float | None = 0.0,
) -> torch.Tensor:
    """Backward-warp float (C, H, W) image through (2, H', W') absolute
    (y, x) coordinates with EASU filtering (reference easu_remap).

    Border semantics match the reference (:385-397): sample centres whose
    4x4 support would leave the image fall back to nearest-neighbour; fully
    outside samples take the background `fill` (None: nearest everywhere).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    c, h, w = img.shape
    ys, xs = sample_map[0], sample_map[1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ppy = ys - y0
    ppx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    flat = img.reshape(c, h * w)
    px = {}
    for letter, (dx, dy) in _TAPS.items():
        yc = torch.clamp(y0i + dy, 0, h - 1)
        xc = torch.clamp(x0i + dx, 0, w - 1)
        px[letter] = flat[:, yc * w + xc]

    easu_val = _easu_core(px, ppx, ppy, fmt)

    easu_ok = (x0i >= 1) & (y0i >= 1) & (x0i < w - 4) & (y0i < h - 4)
    inside = (x0i >= 0) & (y0i >= 0) & (x0i < w) & (y0i < h)
    nearest = px["f"]
    if fill is None:
        out = torch.where(easu_ok, easu_val, nearest)
    else:
        out = torch.where(
            easu_ok, easu_val, torch.where(inside, nearest, float(fill))
        )
    return out[0] if squeeze else out


class ScalePlan(NamedTuple):
    """How `easu_scale` places its samples: the reduced ratios oh/ih = py/qy
    and ow/iw = px/qx, and whether the exact rational form applies."""

    rational: bool
    py: int
    qy: int
    px: int
    qx: int


def scale_plan(in_size: tuple[int, int], out_size: tuple[int, int]) -> ScalePlan:
    """The JAX dispatch rule (livevisionkit_tpu/ops/easu.py:443): the
    rational form for small-rational upscales on both axes jointly (every
    FSR preset: 2, 3/2, 4/3, ...), the fallback form for every other ratio,
    downscales included."""
    (h, w), (oh, ow) = in_size, out_size
    gy, gx = math.gcd(oh, h), math.gcd(ow, w)
    py, qy, px, qx = oh // gy, h // gy, ow // gx, w // gx
    return ScalePlan(max(py, px) <= 8 and py >= qy and px >= qx, py, qy, px, qx)


def _axis_rational(n_out: int, p: int, q: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Source index and fraction of each output row (or column) u of the
    rational form, in integer arithmetic so both are exact: with
    num = 2q*u + q - p, y0 = num // 2p and pp = (num mod 2p) / 2p (the
    half-pixel centre (u + 0.5) * q/p - 0.5)."""
    num = torch.arange(n_out, device=device) * (2 * q) + (q - p)
    y0 = torch.div(num, 2 * p, rounding_mode="floor")
    rem = (num - y0 * (2 * p)).to(torch.float32)
    # A tensor divisor: CUDA divides by a scalar as a product with its
    # reciprocal, which is not the correctly rounded quotient.
    return y0, rem / torch.full_like(rem, 2 * p)


def _axis_fallback(n_in: int, n_out: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Source index and fraction of each output row (or column) of the
    fallback form: y = clip((u + 0.5) * (n_in/n_out) - 0.5, 0, n_in - 1) in
    f32, y0 = floor(y), pp = y - y0."""
    y = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * (n_in / n_out) - 0.5
    y = torch.clamp(y, 0.0, n_in - 1.0)
    y0 = torch.floor(y)
    return y0.to(torch.int64), y - y0


def easu_scale_plain(
    img: torch.Tensor, out_size: tuple[int, int], fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """`easu_scale` as plain PyTorch ops on any device: the CPU path, and
    the reference the scale kernel is held against on the card.

    Separable sample placement (per-axis vectors), 12 gathers, `_easu_core`;
    outside 1 <= y0 < ih-4, 1 <= x0 < iw-4 the output is the nearest tap f.
    At 4K it holds 12 gathered tap planes (~1.2 GB for 3 channels)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    c, h, w = img.shape
    oh, ow = out_size
    plan = scale_plan((h, w), (oh, ow))
    dev = img.device
    if plan.rational:
        y0, ppy = _axis_rational(oh, plan.py, plan.qy, dev)
        x0, ppx = _axis_rational(ow, plan.px, plan.qx, dev)
    else:
        y0, ppy = _axis_fallback(h, oh, dev)
        x0, ppx = _axis_fallback(w, ow, dev)
    y0, ppy = y0[:, None], ppy[:, None].expand(oh, ow)
    x0, ppx = x0[None, :], ppx[None, :].expand(oh, ow)

    px = {}
    for letter, (dx, dy) in _TAPS.items():
        yc = torch.clamp(y0 + dy, 0, h - 1)
        xc = torch.clamp(x0 + dx, 0, w - 1)
        px[letter] = img[:, yc, xc]
    easu_val = _easu_core(px, ppx, ppy, fmt)
    easu_ok = (y0 >= 1) & (y0 < h - 4) & (x0 >= 1) & (x0 < w - 4)
    out = torch.where(easu_ok, easu_val, px["f"])
    return out[0] if squeeze else out


def easu_scale_batched_plain(
    imgs: torch.Tensor, out_size: tuple[int, int], fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """`easu_scale_plain` over a leading stream axis, by torch.func.vmap:
    the batched rule's CPU path, and the reference the scale kernel's
    stream axis is held against on the card."""
    return torch.func.vmap(lambda im: easu_scale_plain(im, out_size, fmt))(imgs)


def easu_scale(
    img: torch.Tensor, out_size: tuple[int, int], fmt: PixelFormat = PixelFormat.YUV
) -> torch.Tensor:
    """EASU resize of a float32 (C, H, W) or (H, W) image to `out_size`
    (reference easu_scale, FSR.cl:324-358), half-pixel convention
    p = (u + 0.5) * (in/out) - 0.5.  A CUDA tensor launches the scale
    kernel (csrc/easu_scale.cu), a CPU tensor takes `easu_scale_plain`.

    It is the custom op ``lvk::easu_scale``, whose vmap rule turns
    `torch.func.vmap` over streams into ONE call of
    ``lvk::easu_scale_batched``: one launch of the kernel over all S
    streams on the card, one call of the plain version on the stacked
    tensors on the CPU."""
    return _easu_scale_op(img, [int(v) for v in out_size], fmt.value)


_SCALE_SCHEMA = "(Tensor img, int[] out_size, str fmt) -> Tensor"


@torch.library.custom_op("lvk::easu_scale", mutates_args=(), schema=_SCALE_SCHEMA)
def _easu_scale_op(img, out_size, fmt):
    """One frame: the scale kernel for a CUDA tensor, the plain version for
    a CPU one."""
    size = tuple(out_size)
    if img.is_cuda:
        plan = scale_plan(tuple(img.shape[-2:]), size)
        return easu_scale_kernel.easu_scale(img, size, plan, fmt=PixelFormat(fmt))
    return easu_scale_plain(img, size, PixelFormat(fmt))


@torch.library.custom_op("lvk::easu_scale_batched", mutates_args=(), schema=_SCALE_SCHEMA)
def _easu_scale_batched_op(img, out_size, fmt):
    """S frames (S, C, H, W) or (S, H, W): one launch of the scale kernel
    for CUDA tensors, the plain version on the stack for CPU ones."""
    size = tuple(out_size)
    if img.is_cuda:
        plan = scale_plan(tuple(img.shape[-2:]), size)
        return easu_scale_kernel.easu_scale_batched(img, size, plan, fmt=PixelFormat(fmt))
    return easu_scale_batched_plain(img, size, PixelFormat(fmt))


@_easu_scale_op.register_fake
@_easu_scale_batched_op.register_fake
def _easu_scale_fake(img, out_size, fmt):
    return img.new_empty(img.shape[:-2] + tuple(out_size))


def _easu_scale_vmap(info, in_dims, img, out_size, fmt):
    """vmap rule of ``lvk::easu_scale``: one batched scale for all streams;
    an unbatched frame is broadcast at stream stride 0, not copied."""
    imgs = stream_first(img, in_dims[0], info.batch_size)
    return _easu_scale_batched_op(imgs, out_size, fmt), 0


_easu_scale_op.register_vmap(_easu_scale_vmap)
