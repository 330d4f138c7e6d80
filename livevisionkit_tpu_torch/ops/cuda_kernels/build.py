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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "liblvk_cuda.so"
PTXAS_LOG = BUILD_DIR / "ptxas.log"  # ptxas -v of the build that made LIB_PATH

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


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


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


def build(verbose: bool = False, csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels of `csrc` (by default the checkout's) into
    `out_dir` if the library there is missing or stale; return its path.
    The library is linked under a temporary name and renamed into place, so
    a concurrent loader never sees a half-written file.  ptxas's report of
    each kernel's registers, shared memory and spills is kept in
    `out_dir`/ptxas.log (`resources`) and printed when `verbose`."""
    sources = _sources(csrc)
    digest = _digest(sources)
    lib_path = out_dir / LIB_PATH.name
    stamp = lib_path.with_name(lib_path.name + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmpdir:
        cus = [p for p in sources if p.suffix == ".cu"]
        objs = [Path(tmpdir) / (p.stem + ".o") for p in cus]
        outs = _run([[nvcc, *NVCC_FLAGS, "--ptxas-options=-v", "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(cus, objs)])
        tmp = Path(tmpdir) / lib_path.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        if verbose:
            print("".join(outs), flush=True)
        (out_dir / PTXAS_LOG.name).write_text("".join(outs))
        os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def resources(log: Path = PTXAS_LOG) -> list[dict]:
    """Each kernel of a build, from its ptxas -v report (by default the
    library's): its demangled name (arguments dropped), registers, static
    shared memory, stack frame and spill bytes."""
    text = log.read_text()
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc_path()), "cu++filt")
    out, entry = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = {"kernel": m.group(1)}
            out.append(entry)
        elif entry is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(sm.group(1)) if sm else 0
    if out and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(e["kernel"] for e in out),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for e, name in zip(out, names):
            e["kernel"] = _short_name(name)
    return out


def _short_name(demangled: str) -> str:
    """`void <unnamed>::k<float, (int)3>(const float *, ...)` -> `k<float, 3>`."""
    name = demangled.removeprefix("void ")
    for ns in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(ns, "")
    depth = 0
    for i in range(len(name) - 1, -1, -1):  # drop the argument list
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
            break
    return name.replace("(int)", "")


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# Each C entry point's argument types; every one returns a CUDA error code
# but lvk_error_string.
_WARP_ARGS = [_p, _p, _p, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i]
_LK_ARGS = [_p, _p, _p, _p, _p, _p, _i, _i, _p, _ll, _p, _ll, _p, _p, _i, _i, _i, _f]
_SCALE_ARGS = [_i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _i, _p]
_ENTRY_POINTS = {
    "lvk_warp": _WARP_ARGS + [_p],
    "lvk_warp_counted": _WARP_ARGS + [_p, _p],
    "lvk_lk_track": _LK_ARGS + [_p],
    "lvk_lk_track_counted": _LK_ARGS + [_p, _p],
    "lvk_easu_scale": [_p, _p] + _SCALE_ARGS,
    "lvk_easu_scale_batched": [_p, _p, _i, _ll] + _SCALE_ARGS,
    "lvk_rcas": [_p, _p, _i, _i, _i, _f, _p],
    "lvk_rcas_batched": [_p, _p, _i, _ll, _i, _i, _i, _f, _p],
    "lvk_cas_batched": [_p, _p, _i, _ll, _i, _i, _i, _f, _p],
    "lvk_ransac": [_p, _ll, _p, _ll, _p, _ll, _p, _ll, _p, _ll, _i, _i, _i, _f, _i, _i,
                   _p, _p, _p, _p, _p, _p],
    "lvk_median_blur": [_p, _p, _i, _i, _i, _i, _p],
    "lvk_deblock": [_p, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _p, _p, _p, _p],
    "lvk_noop": [_p],
    "lvk_mark_stage": [_i, _p],
    "lvk_load_stage_marks": [],
    "lvk_error_string": [_i],
}


@functools.cache
def library(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded kernel library of `csrc` (built on first call), with the
    argument and return types of each entry point it exports declared
    (versions differ in which they export: before the restaged count,
    `lvk_lk_track` took no counter and `lvk_lk_track_counted` was absent;
    before K5 and K6 had a stream axis, `lvk_easu_scale_batched` and
    `lvk_rcas_batched` were absent; before K7, `lvk_ransac`; before K8,
    `lvk_median_blur` and `lvk_deblock`; before K9, `lvk_cas_batched`)."""
    lib = ctypes.CDLL(str(build(csrc=csrc, out_dir=out_dir)))
    for name, args in _ENTRY_POINTS.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_char_p if name == "lvk_error_string" else _i
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().lvk_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")
