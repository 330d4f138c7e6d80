"""Port parity of the pixel-format codecs (runtime/ingest.py) and the
native host binding (runtime/native_host.py): every upload and download
against the JAX package's on the same bytes, at even and odd sizes
(floats within 1e-6, u8 downloads equal), the native codecs against their
numpy paths, and the SPSC frame ring, threaded too."""

import threading

import numpy as np
import pytest
import torch

from livevisionkit_tpu.runtime import ingest as jing
from livevisionkit_tpu_torch.runtime import ingest as ting
from livevisionkit_tpu_torch.runtime import native_host

# Even, odd (chroma planes of ceil / floor size), and odd rows with even
# columns (packed 4:2:2 carries whole pixel pairs: its width is even).
SIZES = [(48, 64), (47, 63), (47, 62)]


def _planes(rng, h, w, ch, cw):
    y = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    gy, gx = np.mgrid[0:ch, 0:cw]
    u = (128 + 60 * np.sin(gx / 5.0) + rng.integers(-8, 9, size=(ch, cw))).clip(0, 255).astype(np.uint8)
    v = (128 + 60 * np.cos(gy / 4.0) + rng.integers(-8, 9, size=(ch, cw))).clip(0, 255).astype(np.uint8)
    return y, u, v


def _same_frame(tf, jf):
    assert tf.format.value == jf.format.value
    np.testing.assert_allclose(tf.pixels.numpy(), np.asarray(jf.pixels), atol=1e-6, rtol=0)
    assert (tf.alpha is None) == (jf.alpha is None)
    if tf.alpha is not None:
        np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), atol=1e-6, rtol=0)
    assert float(tf.timestamp) == float(jf.timestamp)


@pytest.mark.parametrize("size", SIZES)
def test_planar_uploads_match_jax(size):
    h, w = size
    rng = np.random.default_rng(h)
    y, u, v = _planes(rng, h, w, (h + 1) // 2, (w + 1) // 2)
    a = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    _same_frame(ting.upload_i420(y, u, v, ts=0.5, device="cpu"), jing.upload_i420(y, u, v, ts=0.5))
    _same_frame(ting.upload_i40a(y, u, v, a, device="cpu"), jing.upload_i40a(y, u, v, a))
    # I422 / I444: chroma at other plane shapes.
    y2, u2, v2 = _planes(rng, h, w, h, (w + 1) // 2)
    _same_frame(ting.upload_i420(y2, u2, v2, device="cpu"), jing.upload_i420(y2, u2, v2))
    _same_frame(ting.upload_yuva(y2, y2, y2, a, device="cpu"), jing.upload_yuva(y2, y2, y2, a))
    uv = np.stack([u, v], -1)
    _same_frame(ting.upload_nv12(y, uv, device="cpu"), jing.upload_nv12(y, uv))
    _same_frame(ting.upload_nv12(y, uv.reshape(uv.shape[0], -1), device="cpu"),
                jing.upload_nv12(y, uv.reshape(uv.shape[0], -1)))
    _same_frame(ting.upload_gray(y, device="cpu"), jing.upload_gray(y))


def test_packed_uploads_match_jax():
    rng = np.random.default_rng(1)
    h, w = 32, 48
    y, u, v = _planes(rng, h, w, h, w // 2)
    yuy2 = np.zeros((h, w, 2), np.uint8)
    yuy2[:, :, 0], yuy2[:, 0::2, 1], yuy2[:, 1::2, 1] = y, u, v
    uyvy = yuy2[:, :, ::-1].copy()
    for packed, tf, jf in ((yuy2, ting.upload_yuy2, jing.upload_yuy2),
                           (uyvy, ting.upload_uyvy, jing.upload_uyvy)):
        _same_frame(tf(packed, device="cpu"), jf(packed))
        _same_frame(tf(packed.reshape(h, 2 * w), device="cpu"), jf(packed.reshape(h, 2 * w)))
    hwc4 = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    for name in ("upload_ayuv", "upload_rgba", "upload_bgra", "upload_bgrx"):
        _same_frame(getattr(ting, name)(hwc4, device="cpu"), getattr(jing, name)(hwc4))
    _same_frame(ting.upload_bgr(hwc4[..., :3], device="cpu"), jing.upload_bgr(hwc4[..., :3]))


def _frames(size, fmt, alpha, seed):
    """The same float frame in both packages."""
    import livevisionkit_tpu as lj
    import livevisionkit_tpu_torch as lt
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    px = rng.uniform(-0.05, 1.05, size=(3, *size)).astype(np.float32)
    a = rng.uniform(0, 1, size=size).astype(np.float32) if alpha else None
    tf = lt.Frame.create(torch.from_numpy(px), fmt=getattr(lt.PixelFormat, fmt),
                         alpha=None if a is None else torch.from_numpy(a))
    jf = lj.Frame.create(jnp.asarray(px), fmt=getattr(lj.PixelFormat, fmt),
                         alpha=None if a is None else jnp.asarray(a))
    return tf, jf


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == np.shape(w_)
        np.testing.assert_array_equal(g, np.asarray(w_))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("alpha", [False, True])
def test_downloads_match_jax(size, alpha):
    tf, jf = _frames(size, "YUV", alpha, seed=size[0] + alpha)
    names = ["download_i420", "download_nv12", "download_i40a", "download_ayuv"]
    if size[1] % 2 == 0:
        names += ["download_yuy2", "download_uyvy"]
    for name in names:
        _equal(getattr(ting, name)(tf), getattr(jing, name)(jf))
    for fmt in ("RGB", "BGR"):
        tf, jf = _frames(size, fmt, alpha, seed=7)
        _equal(ting.download_rgba(tf), jing.download_rgba(jf))
        _equal(ting.download_bgra(tf), jing.download_bgra(jf))
    with pytest.raises(ValueError):
        ting.download_i420(tf)


def test_native_lib_builds_and_codecs_match_numpy(monkeypatch):
    """The port's build of native/lvk_host.cpp loads, and each native codec
    equals its numpy path (the path taken when get_lib() is None)."""
    lib = native_host.get_lib()
    assert lib is not None
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, size=(20, 30, 2), dtype=np.uint8)
    uv = rng.integers(0, 256, size=(10, 15, 2), dtype=np.uint8)
    planar = rng.uniform(-0.1, 1.1, size=(3, 20, 30)).astype(np.float32)
    hwc = rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)

    def run():
        y, u, v = native_host.unpack_yuy2(packed)
        y2, u2, v2 = native_host.unpack_uyvy(packed)
        su, sv = native_host.split_nv12(uv)
        return [y, u, v, y2, u2, v2, su, sv, native_host.pack_yuy2(y, u, v),
                native_host.pack_uyvy(y2, u2, v2), native_host.interleave_nv12(su, sv),
                native_host.hwc_to_planar(hwc), native_host.planar_f32_to_hwc_u8(planar)]

    native = run()
    monkeypatch.setattr(native_host, "get_lib", lambda: None)
    plain = run()
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native[8], packed)  # pack inverts unpack
    np.testing.assert_array_equal(native[9], packed)


@pytest.mark.parametrize("native", [True, False])
def test_frame_ring(native, monkeypatch):
    if not native:
        monkeypatch.setattr(native_host, "get_lib", lambda: None)
    rng = np.random.default_rng(3)
    ring = native_host.FrameRing(capacity=3, frame_bytes=24)
    assert (ring._lib is not None) == native
    frames = [rng.integers(0, 256, size=24, dtype=np.uint8) for _ in range(5)]
    assert ring.pop() is None
    assert ring.push(frames[0]) and ring.push(frames[1]) and ring.push(frames[2])
    assert not ring.push(frames[3])  # full
    np.testing.assert_array_equal(ring.pop(), frames[0])
    assert ring.push(frames[3])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ring.pop(), frames[i])
    assert len(ring) == 0
    with pytest.raises(ValueError):
        ring.push(np.zeros(23, np.uint8))


def test_frame_ring_threaded():
    """One producer thread and this consumer move 500 frames through an
    8-slot native ring in order, with a short switch interval."""
    import sys

    ring = native_host.FrameRing(capacity=8, frame_bytes=128)
    assert ring._lib is not None
    n = 500
    frames = np.random.default_rng(4).integers(0, 256, size=(n, 128), dtype=np.uint8)
    got = []

    def producer():
        for f in frames:
            while not ring.push(f):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=producer)
        t.start()
        while len(got) < n:
            f = ring.pop()
            if f is not None:
                got.append(f)
        t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.stack(got), frames)
