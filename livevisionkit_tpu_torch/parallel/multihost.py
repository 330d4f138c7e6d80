"""Multi-process scale-out (counterpart of livevisionkit_tpu/parallel/multihost.py).

The JAX package follows JAX's multi-controller recipe: every host runs the
same program, one global ``Mesh(("stream", "tile"))`` spans all hosts'
devices with rows laid out host-major, and each host decodes and feeds
only the streams whose rows live on its devices.  The same holds here on
``torch.distributed``:

  * every process calls :func:`initialize` once (a no-op for one process);
  * :func:`make_global_mesh` lays every process's local devices out
    rank-major, recording each device's owner in ``Mesh.processes``;
  * a process steps only its own rows (:class:`MultiHostStreamFilter`, a
    `MultiStreamFilter` over them), feeds its own streams and fetches its
    own outputs.  No stream talks to another, so the stream axis carries no
    collective in steady state, and no tensor crosses a process: the
    process group (gloo) is the rendezvous and nothing more.  NCCL would
    refuse two ranks on one card, which is what a one-card host runs.

There is no global tensor: :func:`global_frames_from_local` places this
process's streams on its rows, and :func:`fetch_local_outputs` brings them
back, W stripes reassembled.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.parallel.streams import (
    Mesh,
    MultiStreamFilter,
    Shard,
    _groups,
    place,
    unshard,
)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group of a multi-process run (gloo).

    `coordinator_address` is ``host:port`` or an init URL (``tcp://...``,
    ``file://...``); omitted arguments come from the standard variables
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  A silent
    no-op for one process, so the same entry point works everywhere."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes, rank=process_id)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(
    n_streams: int,
    n_tiles: int = 1,
    local_devices: Sequence[torch.device | str] | None = None,
    num_processes: int | None = None,
) -> Mesh:
    """Global ("stream", "tile") mesh over the local devices of every
    process (`local_devices`, the same count in each: by default this
    host's CUDA cards), rank-major: with D local devices and T = n_tiles,
    each process owns D // T consecutive stream rows, keeping a stream's
    tiles on one process.  `num_processes` defaults to the group's size."""
    if local_devices is None:
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local_devices = [torch.device(d) for d in local_devices]
    if num_processes is None:
        num_processes = dist.get_world_size() if dist.is_initialized() else 1
    need = n_streams * n_tiles
    total = len(local_devices) * num_processes
    if total < need:
        raise ValueError(f"need {need} devices, have {total}")
    grid = np.empty(need, dtype=object)
    grid[:] = [local_devices[k % len(local_devices)] for k in range(need)]
    owners = np.arange(need) // len(local_devices)
    return Mesh(grid.reshape(n_streams, n_tiles), ("stream", "tile"),
                processes=owners.reshape(n_streams, n_tiles))


def local_stream_indices(mesh: Mesh, rank: int | None = None) -> list[int]:
    """Stream rows whose devices live on process `rank` (by default this
    one): the streams it decodes and feeds, one a row.  A row split across
    processes raises: its stream could not step in one process."""
    rank = _rank() if rank is None else rank
    rows = mesh.processes.reshape(mesh.shape["stream"], -1)
    local = []
    for i, owners in enumerate(rows):
        if (owners == rank).any():
            if not (owners == rank).all():
                raise ValueError(f"stream row {i} spans processes {sorted(set(owners))}")
            local.append(i)
    return local


def _local_mesh(mesh: Mesh, rank: int | None = None) -> Mesh:
    """The rows of process `rank`, as a mesh of its own."""
    return Mesh(mesh.devices[local_stream_indices(mesh, rank)], mesh.axis_names)


def global_frames_from_local(
    mesh: Mesh, local_frames: Frame, tile_frames: bool = True, rank: int | None = None
) -> list[Shard]:
    """Place this process's decoded frames (a leading axis of
    ``len(local_stream_indices)`` on every tensor, in row order) on its
    rows, W-striped over the tile devices with `tile_frames`."""
    n_local = len(local_stream_indices(mesh, rank))
    if local_frames.pixels.shape[0] != n_local:
        raise ValueError(f"expected {n_local} local streams, got {local_frames.pixels.shape[0]}")
    tile = tile_frames and "tile" in mesh.axis_names
    return place(local_frames, _groups(_local_mesh(mesh, rank), n_local), tile)


def fetch_local_outputs(mesh: Mesh, out: list[Shard]) -> list[np.ndarray]:
    """This process's stream outputs (pixels) on the host, in row order,
    each reassembled from its W stripes."""
    return list(unshard(out, "cpu").pixels.numpy())


class MultiHostStreamFilter:
    """Multi-process wrapper: the same program in every process, each
    stepping, feeding and fetching its own rows of the global mesh.
    `rank` (by default this process's) lets one process run another's
    part."""

    def __init__(self, filt: VideoFilter, mesh: Mesh, tile_frames: bool = True,
                 rank: int | None = None):
        self.filt = filt
        self.mesh = mesh
        self.rank = _rank() if rank is None else rank
        self.n_streams = mesh.shape["stream"]
        self.tile_frames = tile_frames and "tile" in mesh.axis_names
        local = _local_mesh(mesh, self.rank)
        self._inner = MultiStreamFilter(filt, local.shape["stream"], local, tile_frames=tile_frames)

    def local_streams(self) -> list[int]:
        return local_stream_indices(self.mesh, self.rank)

    def init(self, spec: FrameSpec, seed: int = 0) -> Any:
        return self._inner.init(spec, seed=seed)

    def put_frames(self, local_frames: Frame) -> list[Shard]:
        return global_frames_from_local(self.mesh, local_frames, self.tile_frames, self.rank)

    def fetch(self, out: list[Shard]) -> list[np.ndarray]:
        return fetch_local_outputs(self.mesh, out)

    def step(self, states: Any, frames: list[Shard], drain: torch.Tensor | None = None):
        """One tick of this process's streams (`MultiStreamFilter.step`)."""
        return self._inner.step(states, frames, drain)

    def jit_step(self):
        """`step` compiled (`MultiStreamFilter.jit_step`)."""
        return self._inner.jit_step()
