"""Stream batching: S concurrent videos in one step (counterpart of
livevisionkit_tpu/parallel/streams.py, its stream axis).

`MultiStreamFilter` runs a filter's single-stream step over S streams at
once: every state and frame tensor carries a leading stream axis, and the
step is `torch.func.vmap` of the filter's own `step`, as the JAX package's
is `jax.vmap`.  Each of the step's ~1,800 small launches then covers all S
streams, and each hand-written kernel launches once per tick for all of
them through its custom op's vmap rule (ops/remap.py for the warp,
vision/optical_flow.py for LK).  No second, hand-batched copy of the
tracker exists.

RANSAC draws with ``randomness="different"``: each stream draws its own
hypotheses from the state's one generator.  (In the JAX package every
stream starts from the same key.)

Not ported yet: `make_mesh`, `_shard` and the "tile" axis, which spread
streams and frame tiles over devices (ROADMAP A 18).  One H100 holds every
stream here.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import torch
import torch.utils._pytree as pytree

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import CompositeFilter, FrameSpec, VideoFilter
from livevisionkit_tpu_torch.filters.scaling import ScalingFilter


@contextlib.contextmanager
def no_per_stream_fallback() -> Iterator[None]:
    """Make functorch's per-sample fallback an error inside the block.  An
    op without a batching rule otherwise runs silently once per stream
    under vmap, multiplying the step's launches by S."""
    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        functorch._set_vmap_fallback_enabled(was)


def batched(fn: Callable) -> Callable:
    """`fn` over a leading stream axis on every tensor of its arguments and
    results: torch.func.vmap, with random draws that differ per stream and
    no per-stream fallback (an op without a batching rule raises)."""
    vfn = torch.func.vmap(fn, randomness="different")

    def run(*args):
        with no_per_stream_fallback():
            return vfn(*args)

    return run


def _check_batchable(filt: VideoFilter) -> None:
    stages = filt.filters if isinstance(filt, CompositeFilter) else (filt,)
    for f in stages:
        if isinstance(f, CompositeFilter):
            _check_batchable(f)
        elif isinstance(f, ScalingFilter):
            raise NotImplementedError(
                "MultiStreamFilter over ScalingFilter needs vmap rules for the EASU scale "
                "and RCAS kernels (ROADMAP A 17, K5/K6 vmap rules)")


class MultiStreamFilter:
    """Runs a VideoFilter over `n_streams` concurrent streams as one step."""

    def __init__(self, filt: VideoFilter, n_streams: int):
        if n_streams < 1:
            raise ValueError(f"need at least one stream, got {n_streams}")
        _check_batchable(filt)
        self.filt = filt
        self.n_streams = n_streams
        self._step = batched(lambda state, frame, drain: filt.step(state, frame, drain=drain))

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> Any:
        """The filter's initial state, stacked S times on a leading stream
        axis.  One RANSAC generator, seeded with `seed`, serves every
        stream."""
        state = self.filt.init(spec, device=device, seed=seed)
        return pytree.tree_map(lambda t: torch.stack([t] * self.n_streams), state)

    def step(self, states: Any, frames: Frame, drain: torch.Tensor | None = None) -> tuple[Any, Frame]:
        """One tick of every stream.  `frames` carries a leading stream axis
        on each tensor; `drain` is an (S,) bool tensor (default: no stream
        drains).  Returns the stacked states and output frames."""
        if drain is None:
            drain = torch.zeros(self.n_streams, dtype=torch.bool, device=frames.device)
        return self._step(states, frames, drain)
