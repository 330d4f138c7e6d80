"""ctypes bindings for the native host runtime (counterpart of
livevisionkit_tpu/runtime/native_host.py over the same C++ source,
native/lvk_host.cpp).

Builds the shared library on first use (g++ -O3) into
`build/native_host/` under the repository root, and exposes the
packed->planar pixel codecs and the SPSC frame ring.  Every entry point
has a numpy path taken when the library cannot be built or loaded
(`get_lib()` returns None), so the port works without a compiler.  This
is host code: the native path takes the byte shuffles of ingest off the
frame loop (the reference's FrameIngest is native C++ for the same
reason, Modules/OBS-Plugin/Interop/FrameIngest.cpp).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "lvk_host.cpp")
_LIB_DIR = os.path.join(_REPO, "build", "native_host")
_LIB_PATH = os.path.join(_LIB_DIR, "liblvk_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """Compile the library if it is missing or older than its source; link
    under a temporary name and rename it into place, so that a concurrent
    loader never sees a half-written file.  None when g++ fails."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    os.makedirs(_LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=_LIB_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.lvk_unpack_yuy2.argtypes = [u8p, u8p, u8p, u8p, i64, i64]
        lib.lvk_unpack_uyvy.argtypes = [u8p, u8p, u8p, u8p, i64, i64]
        lib.lvk_split_nv12.argtypes = [u8p, u8p, u8p, i64]
        lib.lvk_pack_yuy2.argtypes = [u8p, u8p, u8p, u8p, i64, i64]
        lib.lvk_pack_uyvy.argtypes = [u8p, u8p, u8p, u8p, i64, i64]
        lib.lvk_interleave_nv12.argtypes = [u8p, u8p, u8p, i64]
        lib.lvk_hwc_to_planar.argtypes = [u8p, u8p, i64, i64]
        lib.lvk_planar_to_hwc.argtypes = [u8p, u8p, i64, i64]
        lib.lvk_planar_f32_to_hwc_u8.argtypes = [f32p, u8p, i64, i64, i64]
        lib.lvk_ring_create.restype = ctypes.c_void_p
        lib.lvk_ring_create.argtypes = [i64, i64]
        lib.lvk_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.lvk_ring_push.argtypes = [ctypes.c_void_p, u8p]
        lib.lvk_ring_pop.argtypes = [ctypes.c_void_p, u8p]
        lib.lvk_ring_size.argtypes = [ctypes.c_void_p]
        lib.lvk_ring_size.restype = i64
        _lib = lib
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def unpack_yuy2(packed: np.ndarray):
    """(H, W, 2) YUYV -> (y (H,W), u (H,W/2), v (H,W/2)) uint8 planes."""
    h, w = packed.shape[0], packed.shape[1]
    lib = get_lib()
    if lib is None:
        return packed[:, :, 0].copy(), packed[:, 0::2, 1].copy(), packed[:, 1::2, 1].copy()
    packed = np.ascontiguousarray(packed)
    y = np.empty((h, w), np.uint8)
    u = np.empty((h, w // 2), np.uint8)
    v = np.empty((h, w // 2), np.uint8)
    lib.lvk_unpack_yuy2(_u8(packed), _u8(y), _u8(u), _u8(v), w, h)
    return y, u, v


def unpack_uyvy(packed: np.ndarray):
    h, w = packed.shape[0], packed.shape[1]
    lib = get_lib()
    if lib is None:
        return packed[:, :, 1].copy(), packed[:, 0::2, 0].copy(), packed[:, 1::2, 0].copy()
    packed = np.ascontiguousarray(packed)
    y = np.empty((h, w), np.uint8)
    u = np.empty((h, w // 2), np.uint8)
    v = np.empty((h, w // 2), np.uint8)
    lib.lvk_unpack_uyvy(_u8(packed), _u8(y), _u8(u), _u8(v), w, h)
    return y, u, v


def split_nv12(uv: np.ndarray):
    """(H/2, W/2, 2) interleaved -> (u, v) planes."""
    lib = get_lib()
    if lib is None:
        return uv[..., 0].copy(), uv[..., 1].copy()
    uv = np.ascontiguousarray(uv)
    n = uv.shape[0] * uv.shape[1]
    u = np.empty(uv.shape[:2], np.uint8)
    v = np.empty(uv.shape[:2], np.uint8)
    lib.lvk_split_nv12(_u8(uv), _u8(u), _u8(v), n)
    return u, v


def pack_yuy2(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(y (H,W), u (H,W/2), v (H,W/2)) uint8 planes -> (H, W, 2) YUYV."""
    h, w = y.shape
    lib = get_lib()
    if lib is None:
        out = np.empty((h, w, 2), np.uint8)
        out[:, :, 0] = y
        out[:, 0::2, 1] = u
        out[:, 1::2, 1] = v
        return out
    y, u, v = map(np.ascontiguousarray, (y, u, v))
    out = np.empty((h, w, 2), np.uint8)
    lib.lvk_pack_yuy2(_u8(y), _u8(u), _u8(v), _u8(out), w, h)
    return out


def pack_uyvy(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = y.shape
    lib = get_lib()
    if lib is None:
        out = np.empty((h, w, 2), np.uint8)
        out[:, :, 1] = y
        out[:, 0::2, 0] = u
        out[:, 1::2, 0] = v
        return out
    y, u, v = map(np.ascontiguousarray, (y, u, v))
    out = np.empty((h, w, 2), np.uint8)
    lib.lvk_pack_uyvy(_u8(y), _u8(u), _u8(v), _u8(out), w, h)
    return out


def interleave_nv12(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(u, v) (H/2, W/2) planes -> (H/2, W/2, 2) interleaved chroma."""
    lib = get_lib()
    if lib is None:
        return np.stack([u, v], axis=-1)
    u, v = np.ascontiguousarray(u), np.ascontiguousarray(v)
    out = np.empty(u.shape + (2,), np.uint8)
    lib.lvk_interleave_nv12(_u8(u), _u8(v), _u8(out), u.shape[0] * u.shape[1])
    return out


def hwc_to_planar(hwc: np.ndarray) -> np.ndarray:
    h, w = hwc.shape[:2]
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(hwc.transpose(2, 0, 1))
    hwc = np.ascontiguousarray(hwc)
    out = np.empty((3, h, w), np.uint8)
    lib.lvk_hwc_to_planar(_u8(hwc), _u8(out), w, h)
    return out


def planar_f32_to_hwc_u8(planar: np.ndarray) -> np.ndarray:
    """(C, H, W) float [0,1] -> (H, W, C) uint8 for the encoder."""
    c, h, w = planar.shape
    lib = get_lib()
    if lib is None:
        x = np.clip(planar, 0.0, 1.0)
        return (x.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    out = np.empty((h, w, c), np.uint8)
    lib.lvk_planar_f32_to_hwc_u8(
        planar.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8(out), w, h, c
    )
    return out


class FrameRing:
    """Lock-free SPSC frame ring (native; numpy-deque fallback)."""

    def __init__(self, capacity: int, frame_bytes: int):
        self.capacity = capacity
        self.frame_bytes = frame_bytes
        self._lib = get_lib()
        if self._lib is not None:
            self._ring = self._lib.lvk_ring_create(capacity, frame_bytes)
            if not self._ring:
                self._lib = None
        if self._lib is None:
            from collections import deque

            self._dq = deque()

    def push(self, frame: np.ndarray) -> bool:
        buf = np.ascontiguousarray(frame).view(np.uint8).reshape(-1)
        if buf.nbytes != self.frame_bytes:
            raise ValueError(f"frame of {buf.nbytes} bytes in a ring of {self.frame_bytes}-byte frames")
        if self._lib is None:
            if len(self._dq) >= self.capacity:
                return False
            self._dq.append(buf.copy())
            return True
        return bool(self._lib.lvk_ring_push(self._ring, _u8(buf)))

    def pop(self) -> np.ndarray | None:
        out = np.empty(self.frame_bytes, np.uint8)
        if self._lib is None:
            if not self._dq:
                return None
            return self._dq.popleft()
        if not self._lib.lvk_ring_pop(self._ring, _u8(out)):
            return None
        return out

    def __len__(self) -> int:
        if self._lib is None:
            return len(self._dq)
        return int(self._lib.lvk_ring_size(self._ring))

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_ring", None):
            self._lib.lvk_ring_destroy(self._ring)
            self._ring = None
