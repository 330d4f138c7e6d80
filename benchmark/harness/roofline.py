"""The least time the card could take for a kernel's work, from the cell's
shapes: the larger of its bytes over the memory rate and its float32
operations over the float32 rate (frozen from `chip_smoke.py`'s counts,
which the kernels line of every bring-up run used)."""

from __future__ import annotations

import torch

# The H100 SXM's published peaks (NVIDIA data sheet, at its 700 W limit).
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S) * 1e3


def easu_ops(n_out: int, n_src: int, nc: int) -> int:
    """f32 operations of n_out EASU outputs of nc channels whose bilinear
    corners are n_src distinct source pixels, one per add, sub, mul, div,
    min, max, abs, compare, select and rsqrt of the plain version: a
    corner's direction terms (27) once per source pixel; per output the
    blend of four corners (30), kernel shaping (44), 12 weighted taps (21 +
    2 per channel each), the de-ring window (6 per channel) and the
    normalisation (4 + 3 per channel).  A nearest or fill output costs
    none."""
    return 27 * n_src + n_out * (30 + 44 + 12 * (21 + 2 * nc) + 6 * nc + 4 + 3 * nc)


def easu_work(smap: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(outputs, corner pixels) of a (2, H', W') or (S, 2, H', W') map over
    (h, w) sources: the outputs whose 4x4 EASU support lies inside, and the
    source pixels that are a bilinear corner of one of them, summed over
    the maps."""
    n_out = n_src = 0
    for m in smap.reshape(-1, *smap.shape[-3:]):
        y0, x0 = torch.floor(m[0]).long(), torch.floor(m[1]).long()
        ok = (x0 >= 1) & (y0 >= 1) & (x0 < w - 4) & (y0 < h - 4)
        f = (y0 * w + x0)[ok]
        corner = torch.zeros(h * w, dtype=torch.bool, device=m.device)
        for d in (0, 1, w, w + 1):
            corner[f + d] = True
        n_out += int(ok.sum())
        n_src += int(corner.sum())
    return n_out, n_src


def easu_warp_bound_ms(smap: torch.Tensor, channels: int, src_bytes: int, out_bytes: int) -> float:
    """An EASU warp of `channels` planes through each map of `smap`: every
    source and output byte and the float32 map moved once, and
    `easu_ops`."""
    h, w = smap.shape[-2:]
    n_maps = smap.reshape(-1, *smap.shape[-3:]).shape[0]
    n_out, n_src = easu_work(smap, h, w)
    n_bytes = n_maps * h * w * (channels * (src_bytes + out_bytes) + 8)
    return bound_ms(n_bytes, easu_ops(n_out, n_src, channels))


def lk_ops(n_feat: int, n_levels: int, win: int, iters: int) -> int:
    """f32 operations of the LK kernel, which runs every feature through
    every level and iteration: per level the (win+2)^2 template samples (9
    each), per window pixel the Scharr gradients and the gradient matrix
    (28), ~15 for the eigenvalue test, and per iteration 14 per window pixel
    and ~10 for the step."""
    area = win * win
    per_level = (win + 2) ** 2 * 9 + 28 * area + 15 + iters * (14 * area + 10)
    return n_feat * n_levels * per_level


def lk_bound_ms(level_sizes: list[tuple[int, int]], n_feat: int, win: int, iters: int,
                n_streams: int = 1) -> float:
    """K3 over `n_streams`: both pyramids' float32 levels read once, 25
    bytes a feature (points, initial flow, outputs), and `lk_ops`."""
    n_px = sum(h * w for h, w in level_sizes)
    n_bytes = n_streams * (2 * 4 * n_px + 25 * n_feat)
    return bound_ms(n_bytes, n_streams * lk_ops(n_feat, len(level_sizes), win, iters))


def pyramid_sizes(size: tuple[int, int], levels: int) -> list[tuple[int, int]]:
    """Level sizes of a pyrDown pyramid (each level ceil(n / 2))."""
    out = [tuple(size)]
    for _ in range(levels - 1):
        h, w = out[-1]
        out.append((-(-h // 2), -(-w // 2)))
    return out


def stabilizer_work(config: dict, maps: torch.Tensor, streams: int) -> dict:
    """The warp's and LK's work in a step of a stabilizer configuration:
    the 8-bit queue warped by EASU through `maps` (one a stream), and K3
    on the detection pyramid with the grid's features."""
    tracker = config["filters"][0]["settings"]["tracker"]
    flow = tracker["flow"]
    gh, gw = tracker["detector"]["grid_shape"]
    return {
        "warp": {"maps": maps, "channels": 3, "src_bytes": 1, "out_bytes": 1},
        "lk": {"levels": pyramid_sizes(tuple(tracker["detection_size"]), flow["pyramid_levels"]),
               "features": gh * gw, "window": flow["window_size"], "iterations": flow["iterations"],
               "streams": streams},
    }
