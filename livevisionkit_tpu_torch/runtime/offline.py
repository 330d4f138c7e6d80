"""Offline (batch) clip processing (counterpart of
livevisionkit_tpu/runtime/offline.py's `process_clip`).

Live streaming (runtime/stream.py) optimizes per-frame latency; offline
editing wants throughput.  Here a whole clip held in device memory is
stepped frame by frame with no host round-trip, the counterpart of the JAX
package's `lax.scan`: the frame index is a device counter in the carry,
and one step reads the clip at it, writes the output stacks at it and
advances it, so on the card the loop is one CUDA graph replayed T times
(utils/compiled.jit_step) with no host work between frames.
`process_clip_sharded` splits a clip into chunks over the devices of a
mesh's "time" axis.
"""

from __future__ import annotations

from typing import Any

import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.parallel.streams import Mesh, MultiStreamFilter
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.utils import profiling
from livevisionkit_tpu_torch.utils.compiled import jit_step


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
    `state`, the filter starts from `filt.init` on `device`; a given
    `state` is donated.  The call is one session of utils/profiling.py
    (kind "clip"; spans `replays` and, on the card, `capture`).
    """
    with profiling.session("clip") as sess:
        state, out = _process_clip(filt, pixels, fmt, timestamps, state, torch.device(device))
        sess.frames = out.valid.shape[0]
    return state, out


def _process_clip(filt, pixels, fmt, timestamps, state, device) -> tuple[Any, Frame]:
    pixels = pixels.to(device)
    t_frames, c, h, w = pixels.shape
    if timestamps is None:
        timestamps = torch.arange(t_frames, dtype=torch.float32, device=device) / 30.0
    timestamps = timestamps.to(device=device, dtype=torch.float32)
    spec = FrameSpec(height=h, width=w, channels=c, format=fmt)
    if state is None:
        state = filt.init(spec, device=device)
    out_spec = filt.output_spec(spec)
    out_px = torch.empty((t_frames, out_spec.channels, out_spec.height, out_spec.width),
                         dtype=torch.float32, device=device)
    out_ts = torch.empty(t_frames, dtype=torch.float32, device=device)
    out_valid = torch.empty(t_frames, dtype=torch.bool, device=device)
    live = torch.ones((), dtype=torch.bool, device=device)

    def frame_step(carry):
        """One frame at the carried device index t: read, step, write, t + 1."""
        st, t = carry
        i = t.reshape(1)
        with profiling.trace_scope("ingest"):
            frame = Frame(pixels=pixels.index_select(0, i)[0], timestamp=timestamps.index_select(0, i)[0],
                          valid=live, format=fmt)
        st, out = filt.step(st, frame)
        with profiling.trace_scope("egress"):
            out_px.index_copy_(0, i, out.pixels[None])
            out_ts.index_copy_(0, i, out.timestamp[None])
            out_valid.index_copy_(0, i, out.valid[None])
            t = t + 1
        return (st, t), ()

    step = jit_step(frame_step)
    carry = (state, torch.zeros((), dtype=torch.int64, device=device))
    # On the card the first call captures the graph (the step's `capture`
    # span); every call launches a replay.
    with profiling.trace_scope("replays"):
        for _ in range(t_frames):
            carry, _ = step(carry)
    return carry[0], Frame(pixels=out_px, timestamp=out_ts, valid=out_valid, format=out_spec.format)


def process_clip_sharded(
    filt: VideoFilter,
    pixels: torch.Tensor,  # (T, C, H, W)
    fmt: PixelFormat,
    mesh: Mesh,  # with a "time" axis
    overlap: int = 48,
    timestamps: torch.Tensor | None = None,
    jit: bool = True,
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

    Each group steps through `MultiStreamFilter.jit_step` (a CUDA graph a
    tick on the card; `jit=False` steps op by op).

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
        runs.append((multi.jit_step() if jit else multi.step, idx, pixels.to(dev),
                     timestamps.to(device=dev, dtype=torch.float32)))
        states.append(multi.init(spec, device=dev))
        outs.append([])

    for s in range(steps):
        for g, (step, idx, px, ts) in enumerate(runs):
            i = idx[:, s]
            src = torch.clamp(i, 0, t_frames - 1)
            inside = i < t_frames
            frames = Frame(pixels=torch.where(inside[:, None, None, None], px.index_select(0, src), 0.0),
                           timestamp=torch.where(inside, ts.index_select(0, src), 0.0),
                           valid=i >= 0, format=fmt)
            states[g], out = step(states[g], frames)
            if s >= overlap:
                # A compiled step's outputs last until its next call.
                outs[g].append((out.pixels.clone(), out.timestamp.clone(), out.valid.clone(),
                                out.format))

    # (chunk, step) -> global frame order on the first device, tail dropped.
    first = devices[0]
    by_chunk = {}
    for chunks, group_outs in zip(groups.values(), outs):
        leaves = [torch.stack(leaf, dim=1).to(first) for leaf in zip(*[o[:3] for o in group_outs])]
        for j, d in enumerate(chunks):
            by_chunk[d] = [leaf[j] for leaf in leaves]
    px, ts, valid = (torch.cat([by_chunk[d][k] for d in range(n_dev)])[:t_frames] for k in range(3))
    return Frame(pixels=px, timestamp=ts, valid=valid, format=outs[0][0][3])
