"""VideoFilter: the filter protocol (counterpart of
livevisionkit_tpu/filters/base.py; reference Filters/VideoFilter.hpp).

A filter is a configuration object with an explicit state:

    state = filter.init(spec, device=...)
    state, out_frame = filter.step(state, in_frame, drain=...)

The reference's "empty output" protocol is the Frame's 0-d bool `valid`:
shapes never change, a filter whose output is not ready emits
valid=False, and temporal state must not be corrupted by invalid frames —
`where_state` gates it without reading the flag back to the host.
`CompositeFilter` chains filters; the JAX package's `pool_form` rewrite of
a mid-chain deblocker is an XLA relayout workaround and is not ported.
`ConversionFilter` converts the colour format.
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
    # Whether frames carry a separate alpha plane (Frame.alpha): stateful
    # filters need it to shape their state (the stabilizer's delay queue).
    has_alpha: bool = False

    @classmethod
    def of(cls, frame: Frame) -> "FrameSpec":
        return cls(height=frame.height, width=frame.width, channels=frame.channels,
                   format=frame.format, has_alpha=frame.alpha is not None)

    @property
    def size(self) -> tuple[int, int]:
        """(height, width)."""
        return (self.height, self.width)


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

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> Any:
        """Create the initial state for a stream of `spec` frames on `device`;
        `seed` seeds any random state (the stabilizer's RANSAC generator)."""
        return ()

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        """Process one frame.

        `drain` (a bool or a 0-d bool tensor, per stream; under
        parallel/streams.MultiStreamFilter an (S,) tensor) marks end-of-stream
        flushing: the runtime feeds valid=False bubbles to push delay-queue
        residents out.  Delay filters advance their temporal machinery on
        drain bubbles (with identity motion), whereas ordinary invalid
        frames (a stall tick, an upstream warm-up) freeze it.
        """
        raise NotImplementedError

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        """Spec of output frames (scaling/conversion filters override)."""
        return spec

    @property
    def delay(self) -> int:
        """Output latency in frames (0 unless the filter buffers)."""
        return 0

    @property
    def name(self) -> str:
        return type(self).__name__


class IdentityFilter(VideoFilter):
    """Pass-through (reference IdentityFilter, VideoFilter.hpp:62-64)."""

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        return state, frame


@dataclass(frozen=True)
class CompositeFilter(VideoFilter):
    """Sequential chain (reference CompositeFilter.cpp:60-88).  The state is
    the tuple of the stages' states; `drain` reaches every stage, and an
    upstream warm-up reaches downstream stages as valid=False frames."""

    filters: tuple[VideoFilter, ...]

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> tuple:
        states = []
        for f in self.filters:
            states.append(f.init(spec, device=device, seed=seed))
            spec = f.output_spec(spec)
        return tuple(states)

    def step(self, state: tuple, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[tuple, Frame]:
        new_states = []
        for f, s in zip(self.filters, state):
            s, frame = f.step(s, frame, drain=drain)
            new_states.append(s)
        return tuple(new_states), frame

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        for f in self.filters:
            spec = f.output_spec(spec)
        return spec

    @property
    def delay(self) -> int:
        return sum(f.delay for f in self.filters)

    @property
    def name(self) -> str:
        return "+".join(f.name for f in self.filters)


@dataclass(frozen=True)
class ConversionFilter(VideoFilter):
    """Colour conversion with optional channel extraction (reference
    ConversionFilter.hpp:29-33: a conversion code and `output_channels`,
    cv::cvtColor's dstCn).  `extract_channel` keeps that one plane of the
    converted frame as a single-channel GRAY stream.  Alpha is left as it
    is."""

    target: PixelFormat
    extract_channel: int | None = None

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        out = frame.reformat(self.target)
        if self.extract_channel is not None:
            if not 0 <= self.extract_channel < out.channels:
                raise ValueError(f"extract_channel {self.extract_channel} out of range for "
                                 f"{out.channels}-channel {self.target}")
            k = self.extract_channel
            out = out.replace(pixels=out.pixels[k:k + 1], format=PixelFormat.GRAY)
        return state, out

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        if self.extract_channel is not None:
            return dataclasses.replace(spec, format=PixelFormat.GRAY, channels=1)
        return dataclasses.replace(spec, format=self.target, channels=self.target.channels)
