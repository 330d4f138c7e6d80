"""Grid-based adaptive FAST corner detection, dense and fixed-shape
(counterpart of livevisionkit_tpu/vision/features.py; reference
Vision/FeatureDetector.cpp).

FAST-9/16 is evaluated at every pixel; the suppression grid is the output
(one slot per cell, per-cell argmax, empty cells invalid); the per-region
threshold servo is a small carried tensor.  The score is the summed ring
excess beyond the threshold, which only ranks corners within a cell.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.config import FeatureDetectorSettings

# Bresenham radius-3 circle, circular order, as (dy, dx).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


@dataclass(frozen=True)
class FeatureGrid:
    """Fixed-capacity feature set: one slot per suppression-grid cell."""

    points: torch.Tensor  # (G, 2) float32 (x, y) at detection resolution
    scores: torch.Tensor  # (G,) float32, 0 for empty slots
    valid: torch.Tensor  # (G,) bool


def _contiguous_arc(b: torch.Tensor, arc_length: int) -> torch.Tensor:
    """Any contiguous circular run of >= 9 Trues along axis 0 (= 16), by
    log-composed rolls."""
    if arc_length != 9:
        raise ValueError("the log-roll arc test is specialized to arc length 9")
    a2 = b & torch.roll(b, -1, dims=0)
    a4 = a2 & torch.roll(a2, -2, dims=0)
    a8 = a4 & torch.roll(a4, -4, dims=0)
    a9 = a8 & torch.roll(b, -8, dims=0)
    return a9.any(dim=0)


def fast_score_map(gray: torch.Tensor, threshold_map: torch.Tensor, arc_length: int = 9) -> torch.Tensor:
    """Dense FAST-9/16 corner score at every pixel; 0 = not a corner."""
    h, w = gray.shape
    padded = F.pad(gray[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _RING])
    t = threshold_map
    bright = ring > gray + t
    dark = ring < gray - t
    is_corner = _contiguous_arc(bright, arc_length) | _contiguous_arc(dark, arc_length)
    excess_b = torch.clamp(ring - gray - t, min=0.0).sum(dim=0)
    excess_d = torch.clamp(gray - ring - t, min=0.0).sum(dim=0)
    score = torch.maximum(excess_b, excess_d)
    # A 3-pixel border can never host a full ring: suppress it.  (Built by
    # comparisons: a slice assignment of a Python value copies it from the
    # host, which synchronizes the stream.)
    ys = torch.arange(h, device=gray.device)[:, None]
    xs = torch.arange(w, device=gray.device)[None, :]
    border = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(is_corner & border, score, 0.0)


def _region_threshold_map(thresholds: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Upsample the (R_r, R_c) per-region thresholds to a per-pixel map."""
    rr, rc = thresholds.shape
    h, w = size
    rows = thresholds.repeat_interleave(-(-h // rr), dim=0)[:h]
    return rows.repeat_interleave(-(-w // rc), dim=1)[:, :w]


def _region_index_of_cells(settings: FeatureDetectorSettings, device) -> torch.Tensor:
    """(G,) servo-region index of each suppression-grid cell."""
    gr, gc = settings.grid_shape
    rr, rc = settings.region_shape
    cell_r = torch.arange(gr, device=device)[:, None].expand(gr, gc)
    cell_c = torch.arange(gc, device=device)[None, :].expand(gr, gc)
    return ((cell_r * rr // gr) * rc + (cell_c * rc // gc)).reshape(-1)


def detect(
    gray: torch.Tensor,
    thresholds: torch.Tensor,
    settings: FeatureDetectorSettings,
    prev_features: FeatureGrid | None = None,
) -> tuple[FeatureGrid, torch.Tensor]:
    """Detect up to one corner per grid cell; servo the region thresholds.

    gray: (H, W) detection-resolution luma in [0, 1], H and W divisible by
    the grid.  prev_features: propagated features whose valid slots keep
    their tracked position (reference FeatureDetector.cpp:182-205).
    Returns (features, updated_thresholds).
    """
    h, w = gray.shape
    gr, gc = settings.grid_shape
    if h % gr or w % gc:
        raise ValueError(f"detection size {(h, w)} must divide the suppression grid {(gr, gc)}")
    ch, cw = h // gr, w // gc
    dev = gray.device

    tmap = _region_threshold_map(thresholds, (h, w))
    score = fast_score_map(gray, tmap, settings.fast_arc_length)

    # Per-cell argmax == grid suppression; argmax takes the first maximum,
    # like jnp.argmax.
    cells = score.reshape(gr, ch, gc, cw).permute(0, 2, 1, 3).reshape(gr, gc, -1)
    best = torch.argmax(cells, dim=-1)
    best_score = cells.amax(dim=-1)
    cell_y = torch.arange(gr, device=dev)[:, None] * ch + best // cw
    cell_x = torch.arange(gc, device=dev)[None, :] * cw + best % cw
    points = torch.stack([cell_x, cell_y], dim=-1).reshape(-1, 2).to(torch.float32)
    scores = best_score.reshape(-1)
    valid = scores > 0.0

    features = FeatureGrid(points=points, scores=scores, valid=valid)
    if prev_features is not None:
        keep = prev_features.valid
        features = FeatureGrid(
            points=torch.where(keep[:, None], prev_features.points, points),
            scores=torch.where(keep, torch.maximum(prev_features.scores, scores), scores),
            valid=keep | valid,
        )

    # Threshold servo: per-region valid count vs target cell load (uses the
    # fresh detections' mask, as the JAX version does).
    reg_of_cell = _region_index_of_cells(settings, dev)
    n_regions = settings.region_shape[0] * settings.region_shape[1]
    counts = torch.zeros(n_regions, dtype=torch.float32, device=dev).index_add(
        0, reg_of_cell, valid.to(torch.float32)
    )
    target = settings.target_cell_load * ((gr * gc) / n_regions)
    step = torch.sign(counts - target) * settings.fast_threshold_step
    new_thresholds = torch.clamp(
        thresholds + step.reshape(settings.region_shape),
        settings.fast_threshold_min,
        settings.fast_threshold_max,
    )
    return features, new_thresholds


def initial_thresholds(settings: FeatureDetectorSettings, device=None) -> torch.Tensor:
    return torch.full(settings.region_shape, settings.fast_threshold_init,
                      dtype=torch.float32, device=device)


def rebin(
    points: torch.Tensor,  # (G, 2) tracked positions (x, y)
    scores: torch.Tensor,  # (G,) scores carried from their detection
    valid: torch.Tensor,  # (G,) propagate mask (tracked inliers)
    settings: FeatureDetectorSettings,
    size: tuple[int, int],
) -> FeatureGrid:
    """Re-bin tracked features into their new suppression-grid cells: each
    cell keeps its strongest propagated feature, ties to the lowest slot."""
    h, w = size
    gr, gc = settings.grid_shape
    ch, cw = h // gr, w // gc
    g = gr * gc
    dev = points.device
    cx = torch.clamp(torch.div(points[:, 0], cw, rounding_mode="floor").to(torch.int64), 0, gc - 1)
    cy = torch.clamp(torch.div(points[:, 1], ch, rounding_mode="floor").to(torch.int64), 0, gr - 1)
    cell = cy * gc + cx
    keyed = torch.where(valid, scores, float("-inf"))
    best = torch.full((g,), float("-inf"), dtype=keyed.dtype, device=dev).scatter_reduce(
        0, cell, keyed, reduce="amax", include_self=False
    )
    slot_ids = torch.arange(points.shape[0], device=dev)
    is_best = valid & (keyed == best[cell])
    big = torch.iinfo(torch.int64).max
    winner_slot = torch.full((g,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, cell, torch.where(is_best, slot_ids, big), reduce="amin", include_self=False
    )
    win = is_best & (slot_ids == winner_slot[cell])
    # Losers go to a spare slot g that is cut off afterwards (torch has no
    # "drop" scatter mode, and an out-of-range index faults on CUDA).
    safe_cell = torch.where(win, cell, g)
    idx = (safe_cell,)
    out_points = torch.zeros((g + 1, 2), dtype=torch.float32, device=dev).index_put_(idx, points)
    out_scores = torch.zeros((g + 1,), dtype=torch.float32, device=dev).index_put_(idx, scores)
    out_valid = torch.zeros((g + 1,), dtype=torch.bool, device=dev).index_put_(
        idx, torch.ones_like(win))
    return FeatureGrid(points=out_points[:g], scores=out_scores[:g], valid=out_valid[:g])


def distribution_quality(
    points: torch.Tensor, valid: torch.Tensor, size: tuple[int, int], sectors: int = 4
) -> torch.Tensor:
    """Spatial uniformity in [0, 1]: 1 = perfectly even spread (reference
    SpatialMap::distribution_quality's sector-excess measure)."""
    h, w = size
    sx = torch.clamp((points[:, 0] * (sectors / w)).to(torch.int64), 0, sectors - 1)
    sy = torch.clamp((points[:, 1] * (sectors / h)).to(torch.int64), 0, sectors - 1)
    idx = sy * sectors + sx
    counts = torch.zeros(sectors * sectors, dtype=torch.float32, device=points.device).index_add(
        0, idx, valid.to(torch.float32)
    )
    n = torch.clamp(counts.sum(), min=1.0)
    excess = torch.clamp(counts - n / (sectors * sectors), min=0.0).sum()
    return 1.0 - excess / n
