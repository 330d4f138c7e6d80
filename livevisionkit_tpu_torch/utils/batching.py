"""What `torch.func.vmap` over streams needs (parallel/streams.py).

* `pytree_dataclass` registers a state or frame dataclass as a pytree, so
  vmap maps over its tensors.  Fields that are not tensors (a RANSAC
  generator, a buffer's capacity, a pixel format) are named `static`: they
  ride in the tree's structure, shared by every stream, never batched.  An
  optional field that holds None (a frame without an alpha plane) rides
  there too: torch's pytree takes None for a leaf, which vmap cannot map.
* `stream_first` is what a custom op's vmap rule does to each operand
  before it hands the batch to a kernel (ops/remap.py,
  vision/optical_flow.py): stream axis first, an unbatched operand
  broadcast at stream stride 0 (no copy), each stream's block contiguous.

The JAX package needs neither: its states are flax pytrees and
`custom_vmap` hands the rule plain arrays.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree


def pytree_dataclass(static: tuple[str, ...] = ()):
    """Class decorator: register a dataclass as a pytree whose children are
    its fields but `static` and those that hold None, which go into the
    tree's structure."""

    def register(cls):
        names = tuple(f.name for f in dataclasses.fields(cls))
        children = tuple(n for n in names if n not in static)

        def flatten(obj):
            values = [getattr(obj, n) for n in children]
            absent = tuple(n for n, v in zip(children, values) if v is None)
            return ([v for v in values if v is not None],
                    (tuple(getattr(obj, n) for n in static), absent))

        def unflatten(values, context):
            statics, absent = context
            present = [n for n in children if n not in absent]
            return cls(**dict(zip(present, values)), **dict.fromkeys(absent),
                       **dict(zip(static, statics)))

        pytree.register_pytree_node(cls, flatten, unflatten)
        return cls

    return register


def blocks_contiguous(t: torch.Tensor) -> bool:
    """Every t[s] is contiguous, whatever the stride between them (0
    included); read from the strides, without making a view."""
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def stream_first(t: torch.Tensor, dim: int | None, n_streams: int) -> torch.Tensor:
    """A vmap rule's operand with its stream axis first: moved there from
    `dim`, or, unbatched (`dim` None), broadcast over `n_streams` at stream
    stride 0.  Copied only when a stream's block is not contiguous."""
    t = t.expand(n_streams, *t.shape) if dim is None else t.movedim(dim, 0)
    return t if blocks_contiguous(t) else t.contiguous()
