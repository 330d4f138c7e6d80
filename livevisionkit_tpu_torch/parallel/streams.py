"""Stream batching: S concurrent videos in one step (counterpart of
livevisionkit_tpu/parallel/streams.py, its stream axis).

`MultiStreamFilter` runs a filter's single-stream step over S streams at
once: every state and frame tensor carries a leading stream axis, and the
step is `torch.func.vmap` of the filter's own `step`, as the JAX package's
is `jax.vmap`.  Each of the step's ~1,800 small launches then covers all S
streams, and each hand-written kernel launches once per tick for all of
them through its custom op's vmap rule (ops/remap.py for the warp,
vision/optical_flow.py for LK, ops/easu.py and ops/rcas.py for the
scaler's EASU upscale and RCAS), so any chain of the port's filters
batches, the stabilizer -> `ScalingFilter` chain included.  No second,
hand-batched copy of the tracker exists.

RANSAC draws with ``randomness="different"``: each stream draws its own
hypotheses from the state's one generator.  (In the JAX package every
stream starts from the same key.)

The device mesh.  The JAX package shards the stacked streams over a
``Mesh(("stream", "tile"))`` of its local devices and lets pjit place
them.  Here a `Mesh` is a grid of ``torch.device``s driven by this one
process, and placement is explicit (`_shard`): each mesh row holds its
streams, and with the tile axis a large image-like leaf is split along W
into one stripe per tile device of its row.  A device may repeat in the
grid (on one card every row and tile is ``cuda:0``), so rows that share
their devices form one group and step as ONE batched step: on one card an
(S, 1) mesh makes exactly the meshless tick.  Each group's state has its
own RANSAC generator, on its own device, seeded with the same seed.

The tile axis is placement only.  The warp is an opaque kernel call that
cannot be partitioned: for the step a group gathers its stripes on its
first tile device and re-stripes state and outputs after it, which is what
pjit does around the Pallas warp (all-gathering its operands).  A
tile-sharded warp, with halo exchange and K1 per tile, is
`parallel/spatial.remap_sharded`; the stabilizer's own warp does not go
through it, in either package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter


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


class Mesh:
    """A grid of torch devices with named axes (the counterpart of
    ``jax.sharding.Mesh``): `devices` is an object array of
    ``torch.device``, `shape[axis]` the size of an axis, `processes` the
    owning process of each.  Devices may repeat."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis names, got {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.axis_names = tuple(axis_names)
        # The rank of the process that owns each device (parallel/multihost.py);
        # a mesh of this process alone is all 0.
        self.processes = (np.zeros(grid.shape, dtype=int) if processes is None
                          else np.asarray(processes, dtype=int).reshape(grid.shape))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return list(grid.reshape(-1, grid.shape[-1])[0])


def make_mesh(n_streams: int, n_tiles: int = 1, devices=None) -> Mesh:
    """An (n_streams, n_tiles) ("stream", "tile") mesh over `devices` (a
    device may repeat), by default over the distinct CUDA cards, which must
    be enough."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = n_streams * n_tiles
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_streams, n_tiles), ("stream", "tile"))


def _spec_for_leaf(x: torch.Tensor, tile_w: bool) -> tuple:
    """The leaf's placement, as a JAX PartitionSpec names it: the leading
    (stream) axis over "stream", and with `tile_w` the last axis (W) of a
    large image-like leaf over "tile"."""
    if tile_w and x.ndim >= 3 and x.shape[-1] >= 64 and x.shape[-1] % 2 == 0:
        return ("stream", *([None] * (x.ndim - 2)), "tile")
    return ("stream",)


class Stripes:
    """A leaf split along W, one stripe per tile device of its row (a leaf
    of the placed tree, not a pytree node)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)


@dataclass
class Shard:
    """One group of mesh rows that share their devices: its streams (in
    stream order), its row's tile devices, and its part of a stacked tree,
    each leaf on devices[0] or as `Stripes` over `devices`."""

    streams: tuple[int, ...]
    devices: tuple[torch.device, ...]
    tree: Any


def _groups(mesh: Mesh, n_streams: int) -> list[tuple[tuple[int, ...], tuple[torch.device, ...]]]:
    """(streams, tile devices) of each group of rows with the same devices,
    in order of first row; the streams split evenly over the rows."""
    rows = mesh.devices.reshape(mesh.shape["stream"], -1)
    if n_streams % len(rows):
        raise ValueError(f"{n_streams} streams do not split over {len(rows)} mesh rows")
    per = n_streams // len(rows)
    groups: dict[tuple, list[int]] = {}
    for r, row in enumerate(rows):
        groups.setdefault(tuple(row), []).extend(range(r * per, (r + 1) * per))
    return [(tuple(streams), devs) for devs, streams in groups.items()]


def _take(x: torch.Tensor, streams: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """x's rows `streams` on `dev`: a view when they are consecutive and x
    is already there."""
    a, b = streams[0], streams[-1] + 1
    if streams == tuple(range(a, b)):
        return x[a:b].to(dev)
    return x[list(streams)].to(dev)


def _stripe(tree: Any, devices: tuple[torch.device, ...], tile_w: bool) -> Any:
    """Split each leaf that `_spec_for_leaf` tiles into W stripes over
    `devices` (views where a stripe's device is the leaf's own)."""
    if len(devices) < 2:
        return tree

    def put(x):
        if _spec_for_leaf(x, tile_w)[-1] != "tile":
            return x
        return Stripes([p.to(d) for p, d in zip(torch.tensor_split(x, len(devices), dim=-1), devices)])

    return pytree.tree_map(put, tree)


def _gather(tree: Any, dev: torch.device) -> Any:
    """The whole leaves of a placed tree on `dev`."""
    return pytree.tree_map(
        lambda x: torch.cat([p.to(dev) for p in x.parts], dim=-1) if isinstance(x, Stripes) else x,
        tree)


def place(tree: Any, groups, tile_w: bool) -> list[Shard]:
    """A stacked tree (leading stream axis on every tensor) placed on the
    `_groups` of a mesh: each group's streams on its first tile device, a
    tiled leaf's W stripes on the tile devices.  A tree whose structure
    holds a device-bound object (a state's generator) is placed by
    `MultiStreamFilter.init`."""
    return [Shard(streams, devs, _stripe(pytree.tree_map(lambda x: _take(x, streams, devs[0]), tree),
                                         devs, tile_w))
            for streams, devs in groups]


def unshard(shards: list[Shard], device: torch.device | str) -> Any:
    """The stacked tree, all streams in order, on `device`: what a JAX
    global array holds."""
    device = torch.device(device)
    order = [s for sh in shards for s in sh.streams]
    whole = pytree.tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                            *[_gather(sh.tree, device) for sh in shards])
    if order == sorted(order):
        return whole
    inverse = torch.as_tensor(np.argsort(order), device=device)
    return pytree.tree_map(lambda x: x.index_select(0, inverse), whole)


class MultiStreamFilter:
    """Runs a VideoFilter over `n_streams` concurrent streams as one step,
    or, with a `mesh`, one batched step per group of its rows."""

    def __init__(self, filt: VideoFilter, n_streams: int, mesh: Mesh | None = None,
                 tile_frames: bool = True):
        if n_streams < 1:
            raise ValueError(f"need at least one stream, got {n_streams}")
        self.filt = filt
        self.n_streams = n_streams
        self.mesh = mesh
        self.tile_frames = tile_frames and mesh is not None and "tile" in mesh.axis_names
        self._groups = None if mesh is None else _groups(mesh, n_streams)
        self._step = batched(lambda state, frame, drain: filt.step(state, frame, drain=drain))

    def _shard(self, tree: Any, tile_w: bool) -> list[Shard]:
        """Place a stacked tree (leading stream axis on every tensor) on the
        mesh (`place`)."""
        return place(tree, self._groups, tile_w)

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> Any:
        """The filter's initial state, stacked S times on a leading stream
        axis.  One RANSAC generator, seeded with `seed`, serves every
        stream.  With a mesh (`device` unused): a list of `Shard`s, each
        group's state built on its own first tile device, with its own
        generator seeded with `seed`."""
        if self.mesh is None:
            return self._stack(self.filt.init(spec, device=device, seed=seed), self.n_streams)
        return [Shard(streams, devs, _stripe(self._stack(self.filt.init(spec, device=devs[0], seed=seed),
                                                         len(streams)), devs, self.tile_frames))
                for streams, devs in self._groups]

    @staticmethod
    def _stack(state: Any, n: int) -> Any:
        return pytree.tree_map(lambda t: torch.stack([t] * n), state)

    def step(self, states: Any, frames: Any, drain: torch.Tensor | None = None) -> tuple[Any, Any]:
        """One tick of every stream.  `frames` carries a leading stream axis
        on each tensor; `drain` is an (S,) bool tensor (default: no stream
        drains).  Returns the stacked states and output frames.

        With a mesh, `states` is what `init` returned and `frames` a stacked
        Frame on any device or its `_shard`; each group gathers its stripes
        on its first tile device, steps, and re-stripes.  Returns lists of
        `Shard`s (`unshard` assembles them)."""
        if self.mesh is None:
            if drain is None:
                drain = torch.zeros(self.n_streams, dtype=torch.bool, device=frames.device)
            return self._step(states, frames, drain)
        if not isinstance(frames, list):
            frames = self._shard(frames, tile_w=False)
        new_states, outs = [], []
        for st, fr in zip(states, frames):
            dev = st.devices[0]
            dr = (torch.zeros(len(st.streams), dtype=torch.bool, device=dev) if drain is None
                  else _take(drain, st.streams, dev))
            state, out = self._step(_gather(st.tree, dev), _gather(fr.tree, dev), dr)
            new_states.append(Shard(st.streams, st.devices, _stripe(state, st.devices, self.tile_frames)))
            outs.append(Shard(st.streams, st.devices, _stripe(out, st.devices, self.tile_frames)))
        return new_states, outs
