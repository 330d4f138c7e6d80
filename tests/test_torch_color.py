"""Port parity: colour conversion (`ops/color.convert`, `Frame.reformat`)
against the JAX package, over every pair of formats."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu.ops import color as jcolor
from livevisionkit_tpu_torch.ops import color as tcolor

FORMATS = ["RGB", "BGR", "YUV", "GRAY"]


def _pixels(fmt, seed=0):
    rng = np.random.default_rng(seed)
    c = 1 if fmt == "GRAY" else 3
    return rng.uniform(0.0, 1.0, size=(c, 12, 20)).astype(np.float32)


@pytest.mark.parametrize("src,dst", list(itertools.product(FORMATS, FORMATS)))
def test_convert_matches_jax(src, dst):
    """Every format pair, atol 1e-6: the same float32 matrices, summed in
    another order."""
    px = _pixels(src)
    want = np.asarray(jcolor.convert(jnp.asarray(px), lj.PixelFormat[src], lj.PixelFormat[dst]))
    got = tcolor.convert(torch.from_numpy(px), lt.PixelFormat[src], lt.PixelFormat[dst])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_matrices_match_jax():
    """The RGB <-> YUV matrices and offsets, atol 1e-6."""
    for name in ("rgb_to_yuv_matrix", "yuv_to_rgb_matrix"):
        (mj, oj), (mt, ot) = getattr(jcolor, name)(), getattr(tcolor, name)()
        np.testing.assert_allclose(np.array(mt), np.asarray(mj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(np.array(ot), np.asarray(oj), atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst", [("BGR", "YUV"), ("YUV", "BGR"), ("RGB", "GRAY"), ("GRAY", "YUV")])
def test_frame_reformat_matches_jax(src, dst):
    """Frame.reformat keeps timestamp and flag and converts the planes as
    JAX's does (atol 1e-6); the same format returns the frame itself."""
    px = _pixels(src, seed=1)
    fj = lj.Frame.create(jnp.asarray(px), timestamp=0.5, fmt=lj.PixelFormat[src]).reformat(
        lj.PixelFormat[dst])
    ft0 = lt.Frame.create(torch.from_numpy(px), timestamp=0.5, fmt=lt.PixelFormat[src])
    ft = ft0.reformat(lt.PixelFormat[dst])
    assert ft.format is lt.PixelFormat[dst] and float(ft.timestamp) == 0.5 and bool(ft.valid)
    np.testing.assert_allclose(ft.pixels.numpy(), np.asarray(fj.pixels), atol=1e-6, rtol=0)
    assert ft0.reformat(lt.PixelFormat[src]) is ft0


def test_yuv_round_trip():
    """BGR -> YUV -> BGR is the identity within 1e-6 on [0, 1]."""
    px = torch.from_numpy(_pixels("BGR", seed=2))
    yuv = tcolor.convert(px, lt.PixelFormat.BGR, lt.PixelFormat.YUV)
    back = tcolor.convert(yuv, lt.PixelFormat.YUV, lt.PixelFormat.BGR)
    assert float((back - px).abs().max()) <= 1e-6
