"""Port parity: EASU / bilinear remap (the plain version of the warp kernel)
against the JAX XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livevisionkit_tpu.models.homography import Homography as JH
from livevisionkit_tpu.ops import easu as jeasu
from livevisionkit_tpu.ops import remap as jremap
from livevisionkit_tpu.types import PixelFormat as JPF
from livevisionkit_tpu_torch.models.homography import Homography as TH
from livevisionkit_tpu_torch.ops import easu as teasu
from livevisionkit_tpu_torch.ops import remap as tremap
from livevisionkit_tpu_torch.types import PixelFormat as TPF

SIZE = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.2, 0.8, size=(3,) + SIZE).astype(np.float32)
    img[:, 20:34, 30:52] = 0.95  # hard edges for the edge-adaptive path
    img[0, 40:50, 10:60] = 0.05
    return img


def _map():
    """A stabilization-scale similarity whose corner leaves the frame, so the
    fill and the nearest-neighbour ring are both exercised."""
    m = np.array([[1.03, -0.03, 3.2], [0.03, 1.03, -2.7], [0, 0, 1]], np.float32)
    smap = np.asarray(JH(m=jnp.asarray(m)).sample_map(SIZE))
    out = (smap[0] < 0) | (smap[0] > SIZE[0] - 1) | (smap[1] < 0) | (smap[1] > SIZE[1] - 1)
    assert out.sum() > 50
    return smap


@pytest.mark.parametrize("fill", [0.0, None])
@pytest.mark.parametrize("fmt", ["YUV", "RGB"])
def test_easu_remap_matches_jax(fmt, fill):
    """(f) atol 1e-4 on a [0, 1] scale: rsqrt and the order of sums."""
    img, smap = _image(), _map()
    want = np.asarray(jeasu.easu_remap(jnp.asarray(img), jnp.asarray(smap), fmt=JPF[fmt], fill=fill))
    got = teasu.easu_remap(torch.from_numpy(img), torch.from_numpy(smap), fmt=TPF[fmt], fill=fill)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_remap_matches_jax(mode, dtype):
    """(f) f32: atol 1e-4 on [0, 1].  u8 (filtered on 0..255, rounded half
    to even): at most 1 LSB apart, on at most 0.1% of pixels."""
    img, smap = _image(1), _map()
    if dtype == "uint8":
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    want = np.asarray(jremap.remap(jnp.asarray(img), jnp.asarray(smap), fill=0.0,
                                   filter_mode=mode, fmt=JPF.YUV))
    got = tremap.remap(torch.from_numpy(img), torch.from_numpy(smap), fill=0.0,
                       filter_mode=mode, fmt=TPF.YUV).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "uint8":
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_homography_warp_of_a_larger_source():
    """The map sets the output size: a source larger than the output (the
    clip renderer's texture) warps like the JAX remap."""
    rng = np.random.default_rng(2)
    tex = rng.uniform(size=(1, 90, 120)).astype(np.float32)
    m = np.array([[1.0, 0.01, 11.0], [-0.01, 1.0, 7.5], [0, 0, 1]], np.float32)
    want = np.asarray(jremap.remap(jnp.asarray(tex), JH(m=jnp.asarray(m)).sample_map(SIZE, inverse=False),
                                   fill=0.5, filter_mode="bilinear"))
    got = tremap.remap(torch.from_numpy(tex), TH(m=torch.from_numpy(m)).sample_map(SIZE, inverse=False),
                       fill=0.5, filter_mode="bilinear").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
