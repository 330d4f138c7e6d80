"""The compiled step: `jit_step(fn)`, the counterpart of
``jax.jit(fn, donate_argnums=0)`` in the JAX package.

JAX never runs its step op by op: it compiles it once and dispatches one
program a frame, with the state donated.  PyTorch's counterpart is a CUDA
graph captured once and replayed, with static buffers:

  * `fn(state, *inputs) -> (state, outputs)` over pytrees (the
    `pytree_dataclass` trees of utils/batching.py: Frames, filter states).
  * On CUDA tensors the first call of each signature (the leaves' shapes,
    dtypes and devices, the tree's structure with its static fields, and
    the value of every leaf that is not a tensor, such as a Python `drain`
    flag, and whether tracing is on: utils/profiling.tracing) runs
    `WARMUP_STEPS` steps on copies of the state, on the capture
    stream: the first may do first-use work (the per-shape resize weights
    of ops/resample.py, built from host values; library handles), the
    second must not synchronize.  Then it captures one step.
    All graphs of one `jit_step` share one memory pool.  A capture or a
    replay that fails raises: nothing falls back to the op-by-op step.
  * On CPU tensors it is a plain call of `fn`: no graph, and nothing of
    what follows.

Donation.  The state's tensors live in static buffers (copies made at the
capture); the graph copies the new state into them at its end, and every
call returns that static state.  Passing it back costs nothing; passing
another state of the same signature copies it in (the state passed is
consumed either way, as a donated JAX buffer is).  Every input has a
static buffer too: a call copies its inputs in, unless it passes that
buffer itself (`static_inputs`).  The outputs are the graph's own tensors:
they stay valid until the next call of the same signature, which
overwrites them.  Copy what must outlive that.

The RANSAC generator (a static `torch.Generator` of the tracker's state)
is registered with the graph, so every replay draws fresh hypotheses: the
same draws, from the same seed, as the op-by-op step.  The warm-up's draws
are undone (the generator's state is saved before and restored after).

The step must not synchronize with the host: the second warm-up step and
the capture run with PyTorch's sync-debug mode set to "error", so a
`.item()`, a `bool()` of a tensor or a tensor built from host values
inside the step raises there (and a copy from pageable host memory, which
that mode does not see, fails the capture).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch
import torch.utils._pytree as pytree

from livevisionkit_tpu_torch.utils import profiling

# Op-by-op steps run before each capture, on copies of the state: the
# first with first-use work allowed, the second checked for syncs.
WARMUP_STEPS = 2

# One capture stream per device for every compiled step of the process,
# and one capture at a time.  cuBLAS keeps a workspace for each stream it
# has run on, never freed: a new stream per compiled step grew the
# reserved device memory by ~64 MiB for every `stream_multi` session
# (each builds its own step).
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_CAPTURE_LOCK = threading.RLock()


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _CAPTURE_STREAMS[dev]


@contextlib.contextmanager
def _sync_debug(mode: str) -> Iterator[None]:
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(was)


def _walk_generators(obj: Any, found: list) -> None:
    if isinstance(obj, torch.Generator):
        if not any(obj is g for g in found):
            found.append(obj)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _walk_generators(v, found)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk_generators(v, found)


def generators(leaves: list, spec: pytree.TreeSpec) -> list[torch.Generator]:
    """The generators of a flattened tree: its leaves and its static fields
    (a `pytree_dataclass`'s static values ride in the spec's contexts)."""
    found: list = []
    _walk_generators(leaves, found)
    todo = [spec]
    while todo:
        s = todo.pop()
        _walk_generators(s.context, found)
        # `children()` in newer PyTorch, `children_specs` before it.
        todo.extend(s.children() if hasattr(s, "children") else s.children_specs)
    return found


def _leaf_key(x: Any) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return ("value", type(x), x)


def signature(leaves: list, spec: pytree.TreeSpec) -> tuple:
    """What one graph serves: the tree's structure (its static fields, such
    as a pixel format or a generator, included), each tensor leaf's shape,
    dtype and device, the value of every other leaf, and whether tracing is
    on (a graph captured while tracing holds the stage marks and device
    counters of utils/profiling.py; one captured while not holds none)."""
    return (spec, tuple(_leaf_key(x) for x in leaves), profiling.tracing())


def _same_buffer(x: torch.Tensor, buf: torch.Tensor) -> bool:
    return x is buf or (x.data_ptr() == buf.data_ptr() and x.shape == buf.shape
                        and x.stride() == buf.stride() and x.dtype == buf.dtype)


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The byte range of `t` inside its storage."""
    start = t.storage_offset() * t.element_size()
    extent = sum((n - 1) * s for n, s in zip(t.shape, t.stride()) if n > 0) + 1
    return start, start + extent * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return False
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


@dataclass
class _Graph:
    """One captured signature: the graph, its static buffers (the flattened
    (state, inputs) leaves), and the trees it returns."""

    graph: torch.cuda.CUDAGraph
    device: torch.device
    static: list
    result: tuple

    def run(self, leaves: list) -> tuple:
        with torch.cuda.device(self.device):
            for x, buf in zip(leaves, self.static):
                if isinstance(x, torch.Tensor) and not _same_buffer(x, buf):
                    buf.copy_(x)
            self.graph.replay()
        return self.result


class CompiledStep:
    """`fn(state, *inputs) -> (state, outputs)`, replayed as one CUDA graph
    per signature on CUDA tensors, called as it is on CPU tensors (the
    module docstring gives the buffer rules)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None

    @property
    def n_graphs(self) -> int:
        """Signatures captured so far."""
        return len(self._graphs)

    def __call__(self, state: Any, *inputs: Any) -> tuple[Any, Any]:
        leaves, spec = pytree.tree_flatten((state, inputs))
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if all(d.type == "cpu" for d in devices):
            return self.fn(state, *inputs)
        if len(devices) != 1:
            raise ValueError(f"a compiled step takes tensors on one CUDA device, got {sorted(map(str, devices))}")
        key = signature(leaves, spec)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(leaves, spec, devices.pop())
            leaves = entry.static  # the capture's copies of this call's leaves
        return entry.run(leaves)

    def static_inputs(self, state: Any, *inputs: Any) -> tuple | None:
        """The static buffers of the inputs, for a call of this signature
        (None before its capture, and on the CPU): a caller that writes its
        inputs into them saves the call's copy."""
        leaves, spec = pytree.tree_flatten((state, inputs))
        entry = self._graphs.get(signature(leaves, spec))
        if entry is None:
            return None
        return pytree.tree_unflatten(entry.static, spec)[1]

    def _capture(self, leaves: list, spec: pytree.TreeSpec, dev: torch.device) -> _Graph:
        with profiling.trace_scope("capture"):
            graph = self._capture_graph(leaves, spec, dev)
        profiling.count("graphs_captured")
        return graph

    def _capture_graph(self, leaves: list, spec: pytree.TreeSpec, dev: torch.device) -> _Graph:
        state_leaves, state_spec = pytree.tree_flatten(pytree.tree_unflatten(leaves, spec)[0])
        n_state = len(state_leaves)
        gens = generators(leaves, spec)
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                saved = [g.get_state() for g in gens]
                for k in range(WARMUP_STEPS):
                    copies = [x.clone() if isinstance(x, torch.Tensor) else x for x in static]
                    warm_state, warm_inputs = pytree.tree_unflatten(copies, spec)
                    with _sync_debug("default" if k == 0 else "error"):
                        self.fn(warm_state, *warm_inputs)
                for g, s in zip(gens, saved):
                    g.set_state(s)
            torch.cuda.current_stream(dev).wait_stream(stream)

            graph = torch.cuda.CUDAGraph()
            for g in gens:
                graph.register_generator_state(g)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            state, inputs = pytree.tree_unflatten(static, spec)
            # The capture's own bookkeeping synchronizes (it is the compile);
            # the step inside it must not.
            with _sync_debug("default"), torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                                          capture_error_mode="thread_local"):
                with _sync_debug("error"):
                    new_state, outputs = self.fn(state, *inputs)
                    with profiling.trace_scope("donate"):
                        donate(new_state, static[:n_state], state_spec)
        result = (pytree.tree_unflatten(static[:n_state], state_spec), outputs)
        return _Graph(graph=graph, device=dev, static=static, result=result)


def donate(new_state: Any, buffers: list, spec: pytree.TreeSpec) -> None:
    """Copy the step's new state into the state's static buffers (inside
    the capture).  A new leaf that is its buffer, updated in place, needs
    no copy; one that overlaps another buffer is copied out first, so a
    permutation of the state's tensors cannot overwrite what it reads."""
    new_leaves, new_spec = pytree.tree_flatten(new_state)
    if new_spec != spec:
        raise ValueError(f"the step's new state has another structure than its state:\n"
                         f"{new_spec}\nagainst\n{spec}")
    pending = []
    for new, buf in zip(new_leaves, buffers):
        if not isinstance(buf, torch.Tensor):
            if new != buf:
                raise ValueError(f"the step changed a non-tensor leaf of its state: {buf!r} -> {new!r}")
            continue
        if new.shape != buf.shape or new.dtype != buf.dtype:
            raise ValueError(f"the step changed a state tensor from {tuple(buf.shape)} {buf.dtype} "
                             f"to {tuple(new.shape)} {new.dtype}")
        if new is buf:
            continue
        if any(isinstance(b, torch.Tensor) and _overlaps(new, b) for b in buffers):
            new = new.clone()
        pending.append((buf, new))
    for buf, new in pending:
        buf.copy_(new)


def jit_step(fn: Callable) -> CompiledStep:
    """`fn(state, *inputs) -> (state, outputs)` compiled: a CUDA graph per
    signature on the card, `fn` itself on the CPU (the module docstring
    gives the rules: state donated, outputs valid until the next call)."""
    return CompiledStep(fn)
