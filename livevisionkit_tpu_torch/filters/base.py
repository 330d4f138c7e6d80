"""VideoFilter: the filter protocol (counterpart of
livevisionkit_tpu/filters/base.py; reference Filters/VideoFilter.hpp).

A filter is a configuration object with an explicit state:

    state = filter.init(spec, device=...)
    state, out_frame = filter.step(state, in_frame, drain=...)

The reference's "empty output" protocol is the Frame's 0-d bool `valid`:
shapes never change, a filter whose output is not ready emits
valid=False, and temporal state must not be corrupted by invalid frames —
`where_state` gates it without reading the flag back to the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.types import PixelFormat


@dataclass(frozen=True)
class FrameSpec:
    """Static description of a video stream's frames."""

    height: int
    width: int
    channels: int = 3
    format: PixelFormat = PixelFormat.RGB
    # Frames with a separate alpha plane are not supported by the port yet.
    has_alpha: bool = False


def where_state(pred: torch.Tensor, new: Any, old: Any) -> Any:
    """Select between two states of the same structure, tensor by tensor:
    `new` where the 0-d bool `pred` holds, else `old`.  Dataclasses, dicts
    and tuples are walked; other leaves (ints, generators, formats) are
    taken from `new`."""
    if isinstance(new, torch.Tensor):
        return torch.where(pred, new, old)
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return dataclasses.replace(new, **{
            f.name: where_state(pred, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new) if f.init
        })
    if isinstance(new, dict):
        return {k: where_state(pred, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return tuple(where_state(pred, a, b) for a, b in zip(new, old))
    return new


class VideoFilter:
    """Base class: configuration object + step function."""

    def init(self, spec: FrameSpec, device: torch.device | str = "cpu") -> Any:
        """Create the initial state for a stream of `spec` frames on `device`."""
        return ()

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        """Process one frame.

        `drain` (a bool or a 0-d bool tensor, per stream) marks end-of-stream
        flushing: the runtime feeds valid=False bubbles to push delay-queue
        residents out.  Delay filters advance their temporal machinery on
        drain bubbles (with identity motion), whereas ordinary invalid
        frames (a stall tick, an upstream warm-up) freeze it.
        """
        raise NotImplementedError

    @property
    def delay(self) -> int:
        """Output latency in frames (0 unless the filter buffers)."""
        return 0
