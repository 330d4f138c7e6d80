"""Port parity: ops/resample (antialiased resize, pyrDown pyramid)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livevisionkit_tpu.ops import resample as jres
from livevisionkit_tpu_torch.ops import resample as tres


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "src,dst",
    [((1080, 1920), (272, 480)),  # the flagship detection downscale (y ratio not an integer)
     ((37, 53), (17, 29)),  # small odd sizes
     ((13, 17), (30, 41))],  # upscale: the kernel is not widened
)
def test_resize_antialias_matches_jax(src, dst):
    """(b) atol 1e-5: the same weight matrices, float32 sums in another order."""
    img = np.random.default_rng(0).uniform(size=src).astype(np.float32)
    want = np.asarray(jres.resize(jnp.asarray(img), dst, antialias=True))
    got = tres.resize(torch.from_numpy(img), dst, antialias=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(272, 480), (45, 61)])
def test_build_pyramid_matches_jax(size):
    """(b) atol 1e-5 per level, odd extents included (ceil(n/2) decimation)."""
    img = np.random.default_rng(1).uniform(size=size).astype(np.float32)
    want = jres.build_pyramid(jnp.asarray(img), 3)
    got = tres.build_pyramid(torch.from_numpy(img), 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
