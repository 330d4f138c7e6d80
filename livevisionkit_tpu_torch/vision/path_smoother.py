"""PathSmoother: sliding-window camera-trajectory smoothing (counterpart of
livevisionkit_tpu/vision/path_smoother.py; reference Vision/PathSmoother.cpp).

A 2N+1 window of integrated path positions is convolved with an adaptive
Gaussian whose sigma a hysteresis + EMA servo on the drift error drives;
corrections are clamped into the corrective margins, and the output is
delayed N frames.  During warm-up the Gaussian is renormalized over the
valid entries.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.config import PathSmootherSettings
from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass


@pytree_dataclass()
@dataclass(frozen=True)
class SmootherState:
    positions: StreamBuffer  # window of integrated path positions ({"offsets"})
    position: WarpField  # running integrated camera position
    smoothing: torch.Tensor  # sigma servo factor in [0, 1] (1 = max smoothing)
    drift_ema: torch.Tensor  # EMA of |correction| / corrective_limit


def init(
    settings: PathSmootherSettings, field_shape: tuple[int, int], device: torch.device | str = "cuda"
) -> SmootherState:
    template = WarpField.identity(field_shape, device=device)
    return SmootherState(
        positions=StreamBuffer.create({"offsets": template.offsets}, settings.window),
        position=template,
        smoothing=torch.ones((), dtype=torch.float32, device=device),
        drift_ema=torch.zeros((), dtype=torch.float32, device=device),
    )


def next_correction(
    state: SmootherState, motion: WarpField, settings: PathSmootherSettings
) -> tuple[SmootherState, WarpField, torch.Tensor]:
    """Advance the path by `motion`; return (state, correction, ready).

    The correction takes the frame at the window anchor (predictive_samples
    frames ago) onto the smoothed path; `ready` (0-d bool) goes true once
    the anchor frame exists.  `state` is left intact: the window is copied
    before the push (it is a few hundred bytes), so a caller can still
    revert to `state` wholesale, as the stabilizer does on stall ticks.
    """
    n = settings.predictive_samples
    position = state.position + motion
    buf = state.positions.copy().push({"offsets": position.offsets})

    anchor = buf.count - 1 - n  # logical index of the frame being output
    ready = anchor >= 0
    anchor_c = torch.clamp(anchor, min=0)

    sigma = settings.min_sigma + state.smoothing * (settings.max_sigma - settings.min_sigma)
    idx = torch.arange(settings.window, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-0.5 * ((idx - anchor_c.to(torch.float32)) / sigma) ** 2)
    w = w * buf.window_valid_mask()
    w = w / torch.clamp(w.sum(), min=1e-6)

    smoothed = WarpField(offsets=buf.convolve(w)["offsets"])
    at_anchor = WarpField(offsets=buf.get(anchor_c)["offsets"])
    raw = smoothed - at_anchor

    limit = settings.corrective_limit
    drift = raw.offsets.abs().max() / limit
    ema = state.drift_ema + settings.response_rate * (drift - state.drift_ema)
    target = torch.where(
        ema > settings.drift_high,
        0.0,
        torch.where(ema < settings.drift_low, 1.0, state.smoothing),
    )
    smoothing = state.smoothing + settings.response_rate * (target - state.smoothing)

    correction = raw.clamp(limit, limit)
    new_state = SmootherState(positions=buf, position=position, smoothing=smoothing, drift_ema=ema)
    return new_state, correction, ready


def scene_margins(settings: PathSmootherSettings) -> float:
    """Stable-region margin (fraction of frame): the corrective limit."""
    return settings.corrective_limit
