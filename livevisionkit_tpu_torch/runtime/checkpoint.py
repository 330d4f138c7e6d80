"""Stream-state snapshot / resume (counterpart of
livevisionkit_tpu/runtime/checkpoint.py).

The reference persists only camera-calibration profiles and CLI profiles;
stream state (delay queue, trajectory window, QA servos) is ephemeral.
Here, as in the JAX package, any filter state pytree round-trips through a
single .npz file, so a crashed worker resumes mid-stream without
re-warming the smoothing window.  The RANSAC `torch.Generator` (the
counterpart of the JAX PRNG key) is stored by its state, so a resumed
stream draws the same hypotheses as an uninterrupted one.

`settings_fingerprint` is the JAX package's canonical walk, token for
token: for field-equal settings the port and the JAX package give the
same hex, so a snapshot's fingerprint means the same in both.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import struct
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree


def _canonical(obj: Any, out: list) -> None:
    """Flatten a settings object into a canonical token stream.

    Dataclasses contribute their type name plus every (field-name, value)
    pair in definition order; floats are serialized as their exact IEEE-754
    bits; enums by class+member name.  Anything else falls back to
    type-tagged repr, which is stable for str/int/bool/None.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out.append(f"<{type(obj).__qualname__}")
        for f in dataclasses.fields(obj):
            out.append(f.name + "=")
            _canonical(getattr(obj, f.name), out)
        out.append(">")
    elif isinstance(obj, enum.Enum):
        out.append(f"E:{type(obj).__qualname__}.{obj.name}")
    elif isinstance(obj, bool):  # before int: bool is an int subclass
        out.append(f"b:{obj}")
    elif isinstance(obj, float):
        out.append("f:" + struct.pack("<d", obj).hex())
    elif isinstance(obj, int):
        out.append(f"i:{obj}")
    elif isinstance(obj, (list, tuple)):
        out.append("[" if isinstance(obj, list) else "(")
        for item in obj:
            _canonical(item, out)
        out.append("]" if isinstance(obj, list) else ")")
    elif isinstance(obj, dict):
        out.append("{")
        for k in sorted(obj, key=repr):
            _canonical(k, out)
            out.append(":")
            _canonical(obj[k], out)
        out.append("}")
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        arr = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else obj
        out.append(f"a:{arr.dtype}:{arr.shape}:" + arr.tobytes().hex())
    else:
        out.append(f"{type(obj).__qualname__}:{obj!r}")


def settings_fingerprint(filt: Any) -> str:
    """Stable hash of a filter's full configuration: a canonical walk of the
    frozen-dataclass tree (type names + field names + IEEE-bit-exact values,
    in class-definition order).  Guards resume against a silently different
    configuration whose state happens to have matching leaf shapes."""
    tokens: list = []
    _canonical(filt, tokens)
    return hashlib.sha256("\x00".join(tokens).encode()).hexdigest()[:16]


def _generators(tree: Any) -> list[torch.Generator]:
    """The generators of a state, in a fixed walk order: they ride in the
    pytree's structure (static fields), not among its leaves."""
    out: list = []

    def walk(obj):
        if isinstance(obj, torch.Generator):
            out.append(obj)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, (list, tuple)):
            for item in obj:
                walk(item)
        elif isinstance(obj, dict):
            for k in sorted(obj, key=repr):
                walk(obj[k])

    walk(tree)
    return out


def save_state(path: str, state: Any, filt: Any | None = None) -> None:
    """Snapshot a filter-state pytree to an .npz file.  Pass the filter (or
    any settings object) to stamp its configuration fingerprint into the
    snapshot; load_state then refuses a mismatched configuration.  Reads
    the state back to the host, so it waits for the device."""
    leaves, _ = pytree.tree_flatten(state)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)}
    for i, gen in enumerate(_generators(state)):
        arrays[f"generator_{i}"] = gen.get_state().numpy()
    if filt is not None:
        arrays["settings_hash"] = np.bytes_(settings_fingerprint(filt).encode())
    np.savez_compressed(path, n_leaves=np.int64(len(leaves)), **arrays)


def load_state(path: str, template: Any, filt: Any | None = None) -> Any:
    """Restore a snapshot into the structure of `template` (a freshly
    init()-ed state for the SAME filter configuration), on the template's
    devices.  If both the snapshot and this call carry a filter
    fingerprint, they must match.  The template's generators take the
    snapshot's generator states."""
    with np.load(path) as data:
        if filt is not None and "settings_hash" in data:
            want = settings_fingerprint(filt)
            got = bytes(data["settings_hash"]).decode()
            if got != want:
                raise ValueError(
                    f"snapshot was taken under a different filter configuration "
                    f"(fingerprint {got} != {want}); refusing to resume"
                )
        leaves_t, treedef = pytree.tree_flatten(template)
        n = int(data["n_leaves"])
        if n != len(leaves_t):
            raise ValueError(
                f"snapshot has {n} leaves, filter state expects {len(leaves_t)} "
                "(was the filter configuration changed?)"
            )
        leaves = []
        for i, tmpl in enumerate(leaves_t):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"leaf {i}: snapshot shape {arr.shape} != state shape {tuple(tmpl.shape)}")
            leaves.append(torch.from_numpy(arr.copy()).to(device=tmpl.device, dtype=tmpl.dtype))
        gens = _generators(template)
        n_gen = sum(1 for k in data.files if k.startswith("generator_"))
        if n_gen != len(gens):
            raise ValueError(f"snapshot has {n_gen} generators, filter state expects {len(gens)}")
        for i, gen in enumerate(gens):
            gen.set_state(torch.from_numpy(data[f"generator_{i}"].copy()))
    return pytree.tree_unflatten(leaves, treedef)
