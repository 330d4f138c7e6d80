"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface, ``build/torch_kernels/
liblvk_cuda.so`` under the repository root, loaded with ``ctypes``.  The
build runs at first use, from the sources in the checkout alone; it is
repeated only when a source changes (a SHA-256 of the sources sits beside the
library).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "liblvk_cuda.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their outputs, or raise with the
    first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library is missing or stale; return its
    path.  The library is linked under a temporary name and renamed into
    place, so a concurrent loader never sees a half-written file."""
    sources = _sources()
    digest = _digest(sources)
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    ptxas = ["--ptxas-options=-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        cus = [p for p in sources if p.suffix == ".cu"]
        objs = [Path(tmpdir) / (p.stem + ".o") for p in cus]
        outs = _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(cus, objs)])
        tmp = Path(tmpdir) / LIB_PATH.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        if verbose:
            print("".join(outs), flush=True)
        os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.lvk_warp.argtypes = [p, p, p, i, ll, ll, i, i, i, i, i, i, i, i, f, i, p]
    lib.lvk_warp.restype = i
    lib.lvk_lk_track.argtypes = [p, p, p, p, p, p, i, i, p, ll, p, ll, p, p, i, i, i, f, p]
    lib.lvk_lk_track.restype = i
    lib.lvk_easu_scale.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.lvk_easu_scale.restype = i
    lib.lvk_rcas.argtypes = [p, p, i, i, i, f, p]
    lib.lvk_rcas.restype = i
    lib.lvk_error_string.argtypes = [i]
    lib.lvk_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().lvk_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")
