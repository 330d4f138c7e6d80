"""Offline (batch) clip processing (counterpart of
livevisionkit_tpu/runtime/offline.py's `process_clip`).

Live streaming (runtime/stream.py) optimizes per-frame latency; offline
editing wants throughput.  Here a whole clip held in device memory is
stepped frame by frame with no host round-trip: a Python loop of
`filt.step` over the T frames (the JAX package's `lax.scan`), outputs
stacked into one Frame with a leading T axis.  `process_clip_sharded`, the
temporal sharding over several devices, is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.types import PixelFormat


def process_clip(
    filt: VideoFilter,
    pixels: torch.Tensor,  # (T, C, H, W) float planes
    fmt: PixelFormat,
    timestamps: torch.Tensor | None = None,
    state: Any | None = None,
    device: torch.device | str = "cuda",
) -> tuple[Any, Frame]:
    """Run `filt` over a whole clip on `device` (the clip is moved there if
    it lies elsewhere).

    Returns (final_state, outputs) where outputs is a Frame with a leading
    T axis (pixels (T, C, H', W'), valid (T,), timestamp (T,)).  Invalid entries (warm-up delay) are flagged, not
    removed: filter the batch on the host with `outputs.valid`.  Without
    `state`, the filter starts from `filt.init` on `device`.
    """
    device = torch.device(device)
    pixels = pixels.to(device)
    t_frames, c, h, w = pixels.shape
    if timestamps is None:
        timestamps = torch.arange(t_frames, dtype=torch.float32, device=device) / 30.0
    timestamps = timestamps.to(device=device, dtype=torch.float32)
    if state is None:
        state = filt.init(FrameSpec(height=h, width=w, channels=c, format=fmt), device=device)
    live = torch.ones((), dtype=torch.bool, device=device)
    outs = []
    for t in range(t_frames):
        frame = Frame(pixels=pixels[t], timestamp=timestamps[t], valid=live, format=fmt)
        state, out = filt.step(state, frame)
        outs.append(out)
    return state, Frame(
        pixels=torch.stack([o.pixels for o in outs]),
        timestamp=torch.stack([o.timestamp for o in outs]),
        valid=torch.stack([o.valid for o in outs]),
        format=outs[0].format,
    )
