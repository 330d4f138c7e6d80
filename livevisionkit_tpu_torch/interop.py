"""Carry a running stabilizer's (or filter chain's) state from the JAX
package into the port.

The engine has no weights: its state (pyramid, features, detector
thresholds, smoother window, delay queue, trust and scene quality) is what
"parameters" means here.  `stabilizer_state_from_numpy` takes the JAX
``StabilizerState`` with numpy leaves — e.g. ``jax.tree.map(np.asarray,
state)`` — and reads it by attribute name only, so this module imports
neither JAX nor the JAX package.  The JAX PRNG key is not carried: the
port's RANSAC generator is seeded instead.

The leaf conversions keep every leaf's shape, so a batched JAX state, whose
leaves carry a leading stream axis (``jax.vmap`` of ``init`` or of
``step``), becomes the port's batched state for
parallel/streams.MultiStreamFilter through the same functions.
"""

from __future__ import annotations

import numpy as np
import torch

from livevisionkit_tpu_torch.config import StabilizationFilterSettings
from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer
from livevisionkit_tpu_torch.filters.base import VideoFilter
from livevisionkit_tpu_torch.filters.stabilization import StabilizationFilter, StabilizerState
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
    """The port's StabilizerState equal to a JAX one given as numpy leaves,
    in either motion model (the mesh solve's previous local mesh is
    carried in both, as the JAX state holds it in both)."""
    tr = tree.tracker
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mesh_shape = tuple(np.shape(tr.prev_mesh)[-2:])
    if mesh_shape != tuple(settings.tracker.motion_resolution):
        raise ValueError(f"state's mesh {mesh_shape} is not the settings' motion_resolution "
                         f"{tuple(settings.tracker.motion_resolution)}")
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
        prev_mesh=_t(tr.prev_mesh, device, torch.float32),
        has_prev_mesh=_t(tr.has_prev_mesh, device, torch.bool),
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
    pixels = _t(fq.data.pixels, device)
    if pixels.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"unexpected delay-queue dtype {pixels.dtype}")
    data = {
        "pixels": pixels,
        "timestamp": _t(fq.data.timestamp, device, torch.float32),
        "valid": _t(fq.data.valid, device, torch.bool),
    }
    if getattr(fq.data, "alpha", None) is not None:  # a queue of frames with alpha
        data["alpha"] = _t(fq.data.alpha, device, pixels.dtype)
    frames = StreamBuffer(
        data=data,
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


def composite_state_from_numpy(
    tree, filters: tuple[VideoFilter, ...], device: torch.device | str, seed: int = 0
) -> tuple:
    """The port's CompositeFilter state equal to a JAX chain's, given as
    numpy leaves, for the port's `filters` (a CompositeFilter's `.filters`):
    a stabilizer stage goes through `stabilizer_state_from_numpy` (its
    RANSAC generator seeded with `seed`), a stateless stage (a deblocker,
    CAS, a scaler, a conversion) maps () to ()."""
    if len(tree) != len(filters):
        raise ValueError(f"{len(tree)} stage states for {len(filters)} filters")
    states = []
    for sub, f in zip(tree, filters):
        if isinstance(f, StabilizationFilter):
            states.append(stabilizer_state_from_numpy(sub, f.settings, device, seed=seed))
        elif isinstance(sub, tuple) and not sub:
            states.append(())
        else:
            raise NotImplementedError(f"no state conversion for {f.name}")
    return tuple(states)

