"""Offline (batch) clip processing (counterpart of
livevisionkit_tpu/runtime/offline.py's `process_clip`).

Live streaming (runtime/stream.py) optimizes per-frame latency; offline
editing wants throughput.  Here a whole clip held in device memory is
stepped frame by frame with no host round-trip: a Python loop of
`filt.step` over the T frames (the JAX package's `lax.scan`), outputs
stacked into one Frame with a leading T axis.  `process_clip_sharded`
splits a clip into chunks over the devices of a mesh's "time" axis.
"""

from __future__ import annotations

from typing import Any

import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.parallel.streams import Mesh, MultiStreamFilter
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


def process_clip_sharded(
    filt: VideoFilter,
    pixels: torch.Tensor,  # (T, C, H, W)
    fmt: PixelFormat,
    mesh: Mesh,  # with a "time" axis
    overlap: int = 48,
    timestamps: torch.Tensor | None = None,
) -> Frame:
    """Temporal sharding with halo overlap (SURVEY.md section 5.7): the clip
    splits into one chunk per device of the mesh's "time" axis, and each
    chunk first re-runs the `overlap` frames before it (zero frames flagged
    invalid for chunk 0), so its temporal state (delay queue, trajectory
    window, QA servos) has converged when its own region starts.  No chunk
    talks to another.  Chunks whose device is the same run as one batched
    step (parallel/streams.MultiStreamFilter over a stream axis), so four
    chunks on one card make one 4-stream tick a frame.

    `overlap` must exceed the filter's delay plus its smoothing window (and
    some servo settling).  Returns a Frame with a leading T axis on the
    axis's first device; entries whose `valid` is False (the global
    warm-up and each chunk's first outputs) are to be dropped by the
    caller.

    Port deviation: each chunk draws its own RANSAC hypotheses (one
    generator a device, seeded with 0, under ``randomness="different"``);
    in the JAX package every chunk starts from the same key.
    """
    devices = mesh.along("time")
    n_dev = len(devices)
    t_frames, c, h, w = pixels.shape
    if timestamps is None:
        timestamps = torch.arange(t_frames, dtype=torch.float32, device=pixels.device) / 30.0
    chunk = -(-t_frames // n_dev)
    steps = overlap + chunk
    spec = FrameSpec(height=h, width=w, channels=c, format=fmt)
    groups: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(devices):
        groups.setdefault(dev, []).append(d)

    runs, states, outs = [], [], []
    for dev, chunks in groups.items():
        multi = MultiStreamFilter(filt, len(chunks))
        # Frame index of every step of every chunk: chunk d re-runs frames
        # d * chunk - overlap ..., then runs its own; beyond the clip's end
        # come zero frames (tail padding), before its start invalid ones.
        idx = torch.stack([torch.arange(steps, device=dev) + (d * chunk - overlap) for d in chunks])
        runs.append((multi, idx, pixels.to(dev), timestamps.to(device=dev, dtype=torch.float32)))
        states.append(multi.init(spec, device=dev))
        outs.append([])

    for s in range(steps):
        for g, (multi, idx, px, ts) in enumerate(runs):
            i = idx[:, s]
            src = torch.clamp(i, 0, t_frames - 1)
            inside = i < t_frames
            frames = Frame(pixels=torch.where(inside[:, None, None, None], px.index_select(0, src), 0.0),
                           timestamp=torch.where(inside, ts.index_select(0, src), 0.0),
                           valid=i >= 0, format=fmt)
            states[g], out = multi.step(states[g], frames)
            if s >= overlap:
                outs[g].append(out)

    # (chunk, step) -> global frame order on the first device, tail dropped.
    first = devices[0]
    by_chunk = {}
    for chunks, group_outs in zip(groups.values(), outs):
        leaves = [torch.stack(leaf, dim=1).to(first)
                  for leaf in zip(*[(o.pixels, o.timestamp, o.valid) for o in group_outs])]
        for j, d in enumerate(chunks):
            by_chunk[d] = [leaf[j] for leaf in leaves]
    px, ts, valid = (torch.cat([by_chunk[d][k] for d in range(n_dev)])[:t_frames] for k in range(3))
    return Frame(pixels=px, timestamp=ts, valid=valid, format=outs[0][0].format)
