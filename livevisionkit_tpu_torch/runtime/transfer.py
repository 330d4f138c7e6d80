"""Host <-> device frame transfer without host syncs, shared by the solo
driver (runtime/stream.py) and the multi-stream driver
(runtime/multistream.py).

On a CUDA device, uploads are staged in a ring of pinned host buffers and
copied without blocking; a slot is refilled only after the event recorded
behind its last copy has passed.  With a ring of `inflight + 1` slots and
a driver that keeps at most `inflight` outputs pending, that event has
always passed by the time the slot comes round again.  Outputs come back
the same way: a non-blocking copy into pinned memory behind one event, on
which the driver waits only when it needs the host copy.  On the CPU both
directions are plain copies and there is no event.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Uploader:
    """A ring of `slots` sets of host buffers, one buffer per (shape,
    dtype) of `shapes`.  `host()` hands out the next set as numpy arrays to
    fill in place; `send()` copies it to `device` and returns the device
    tensors."""

    def __init__(self, shapes: Sequence[tuple[tuple[int, ...], torch.dtype]],
                 device: torch.device | str, slots: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.buffers = [[torch.empty(tuple(shape), dtype=dtype, pin_memory=self.cuda)
                         for shape, dtype in shapes] for _ in range(slots)]
        self.events: list = [None] * slots
        self.slot = 0

    def host(self) -> list[np.ndarray]:
        """The next slot's buffers, once the copy last made from them has
        passed."""
        k = self.slot
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return [b.numpy() for b in self.buffers[k]]

    def send(self, out: Sequence[torch.Tensor] | None = None) -> list[torch.Tensor]:
        """Copy the slot filled since `host()` to the device, into `out`
        when given (a compiled step's static inputs), and move on."""
        k = self.slot
        self.slot = (k + 1) % len(self.buffers)
        if out is None:
            out = [b.to(self.device, non_blocking=True) if self.cuda else b.clone()
                   for b in self.buffers[k]]
        else:
            out = list(out)
            for dst, b in zip(out, self.buffers[k]):
                dst.copy_(b, non_blocking=self.cuda)
        if self.cuda:
            self.events[k] = torch.cuda.Event()
            self.events[k].record(torch.cuda.current_stream(self.device))
        return out


def download(out: Sequence[torch.Tensor]):
    """Start copying device tensors to the host; return the host tensors and
    the event to wait on before reading them (None on the CPU, where they
    are copies made at once)."""
    if out[0].device.type != "cuda":
        return tuple(t.clone() for t in out), None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
    for h, t in zip(host, out):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out[0].device))
    return host, event
