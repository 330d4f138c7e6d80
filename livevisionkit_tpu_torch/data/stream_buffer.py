"""StreamBuffer: fixed-capacity circular window of tensors (counterpart of
livevisionkit_tpu/data/stream_buffer.py; reference Data/StreamBuffer.hpp).

It backs the PathSmoother's trajectory window and the StabilizationFilter's
frame delay queue.  ``data`` maps a name to a tensor whose leading axis is
the capacity; ``start`` and ``count`` are 0-d int64 tensors on the same
device, so no operation here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class StreamBuffer:
    data: dict[str, torch.Tensor]  # every tensor has leading dim == capacity
    start: torch.Tensor  # 0-d int64 physical index of the oldest element
    count: torch.Tensor  # 0-d int64 number of valid elements
    capacity: int

    @classmethod
    def create(cls, template: dict[str, torch.Tensor], capacity: int) -> "StreamBuffer":
        """Empty buffer shaped after a single-element `template`."""
        data = {
            k: torch.zeros((capacity,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in template.items()
        }
        dev = next(iter(template.values())).device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return cls(data=data, start=zero, count=zero.clone(), capacity=capacity)

    def copy(self) -> "StreamBuffer":
        """A buffer with its own storage (push writes in place)."""
        return dataclasses.replace(
            self, data={k: v.clone() for k, v in self.data.items()}
        )

    def is_full(self) -> torch.Tensor:
        return self.count >= self.capacity

    def _slot(self, logical: torch.Tensor) -> torch.Tensor:
        return torch.remainder(self.start + logical, self.capacity)

    def push(
        self, elem: dict[str, torch.Tensor], advance: torch.Tensor | None = None
    ) -> "StreamBuffer":
        """Append; evicts the oldest element when full.

        The slot write is IN PLACE (one `index_copy_` per tensor): the JAX
        buffer is immutable and returns a new array, but a functional copy
        of the 1080p u8 delay queue would move the whole window every frame.
        The returned buffer shares its storage with `self`; callers that
        need the pre-push contents must `copy()` first.

        `advance` (0-d bool, default always-true) gates the counters only:
        `elem` is still written to the slot a normal push would use (when
        full, the oldest slot — already emitted by a delay queue), but
        start/count stay put, so `oldest()` then returns `elem` itself.
        """
        full = self.is_full()
        write_slot = torch.where(
            full, self.start, torch.remainder(self.start + self.count, self.capacity)
        )
        idx = write_slot.reshape(1)
        for k, d in self.data.items():
            d.index_copy_(0, idx, elem[k].to(d.dtype).unsqueeze(0))
        new_start = torch.where(
            full, torch.remainder(self.start + 1, self.capacity), self.start
        )
        new_count = torch.where(full, self.count, self.count + 1)
        if advance is not None:
            new_start = torch.where(advance, new_start, self.start)
            new_count = torch.where(advance, new_count, self.count)
        return dataclasses.replace(self, start=new_start, count=new_count)

    def get(self, logical: int | torch.Tensor) -> dict[str, torch.Tensor]:
        """Element at logical index (0 = oldest)."""
        idx = self._slot(logical).reshape(1)
        return {k: d.index_select(0, idx)[0] for k, d in self.data.items()}

    def oldest(self) -> dict[str, torch.Tensor]:
        return self.get(0)

    def logical_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """w_phys[slot] = w_logical[(slot - start) mod capacity] (a gather,
        not `torch.roll`, whose shift would have to be a host integer)."""
        slots = torch.arange(self.capacity, device=weights.device)
        return weights[torch.remainder(slots - self.start, self.capacity)]

    def convolve(self, weights: torch.Tensor) -> dict[str, torch.Tensor]:
        """Weighted sum over the window, weights indexed logically (reference
        StreamBuffer::convolve_at)."""
        w = self.logical_weights(weights)
        return {
            k: torch.tensordot(w.to(d.dtype), d, dims=([0], [0]))
            for k, d in self.data.items()
        }

    def window_valid_mask(self) -> torch.Tensor:
        """(capacity,) float mask of logically-valid positions."""
        idx = torch.arange(self.capacity, device=self.count.device)
        return (idx < self.count).to(torch.float32)
