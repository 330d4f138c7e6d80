"""Carry a running stabilizer's state from the JAX package into the port.

The engine has no weights: its state (pyramid, features, detector
thresholds, smoother window, delay queue, trust and scene quality) is what
"parameters" means here.  `stabilizer_state_from_numpy` takes the JAX
``StabilizerState`` with numpy leaves — e.g. ``jax.tree.map(np.asarray,
state)`` — and reads it by attribute name only, so this module imports
neither JAX nor the JAX package.  The JAX PRNG key is not carried: the
port's RANSAC generator is seeded instead.
"""

from __future__ import annotations

import numpy as np
import torch

from livevisionkit_tpu_torch.config import StabilizationFilterSettings
from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer
from livevisionkit_tpu_torch.filters.stabilization import StabilizerState
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.vision import frame_tracker, path_smoother
from livevisionkit_tpu_torch.vision.features import FeatureGrid
from livevisionkit_tpu_torch.vision.optical_flow import Pyramid


def _t(x, device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(arr.copy())
    if dtype is not None:
        t = t.to(dtype)
    elif t.dtype == torch.int32:
        t = t.to(torch.int64)
    return t.to(device)


def stabilizer_state_from_numpy(
    tree, settings: StabilizationFilterSettings, device: torch.device | str, seed: int = 0
) -> StabilizerState:
    """The port's StabilizerState equal to a JAX one given as numpy leaves."""
    tr = tree.tracker
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if tuple(settings.tracker.motion_resolution) != (2, 2):
        raise NotImplementedError("mesh-mode state is ROADMAP slice 2")
    tracker = frame_tracker.TrackerState(
        pyramid=Pyramid(levels=tuple(_t(lv, device, torch.float32) for lv in tr.pyramid.levels)),
        features=FeatureGrid(
            points=_t(tr.features.points, device, torch.float32),
            scores=_t(tr.features.scores, device, torch.float32),
            valid=_t(tr.features.valid, device, torch.bool),
        ),
        thresholds=_t(tr.thresholds, device, torch.float32),
        has_prev=_t(tr.has_prev, device, torch.bool),
        generator=gen,
    )

    sm = tree.smoother
    smoother = path_smoother.SmootherState(
        positions=StreamBuffer(
            data={"offsets": _t(sm.positions.data.offsets, device, torch.float32)},
            start=_t(sm.positions.start, device, torch.int64),
            count=_t(sm.positions.count, device, torch.int64),
            capacity=int(sm.positions.capacity),
        ),
        position=WarpField(offsets=_t(sm.position.offsets, device, torch.float32)),
        smoothing=_t(sm.smoothing, device, torch.float32),
        drift_ema=_t(sm.drift_ema, device, torch.float32),
    )

    fq = tree.frames
    if getattr(fq.data, "alpha", None) is not None:
        raise NotImplementedError("alpha planes are not ported yet (ROADMAP slice 5)")
    pixels = _t(fq.data.pixels, device)
    if pixels.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"unexpected delay-queue dtype {pixels.dtype}")
    frames = StreamBuffer(
        data={
            "pixels": pixels,
            "timestamp": _t(fq.data.timestamp, device, torch.float32),
            "valid": _t(fq.data.valid, device, torch.bool),
        },
        start=_t(fq.start, device, torch.int64),
        count=_t(fq.count, device, torch.int64),
        capacity=int(fq.capacity),
    )
    return StabilizerState(
        tracker=tracker,
        smoother=smoother,
        frames=frames,
        scene_quality=_t(tree.scene_quality, device, torch.float32),
        trust=_t(tree.trust, device, torch.float32),
        stability=_t(tree.stability, device, torch.float32),
        uniformity=_t(tree.uniformity, device, torch.float32),
        correction=WarpField(offsets=_t(tree.correction.offsets, device, torch.float32)),
    )
