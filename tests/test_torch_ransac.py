"""Port parity: RANSAC + IRLS with the JAX draw's minimal sets injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livevisionkit_tpu.config import MotionEstimationSettings
from livevisionkit_tpu.models.homography import Homography as JH
from livevisionkit_tpu.vision import ransac as jr
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.vision import ransac as tr


# One compiled JAX estimate for every case (the model choice is traced).
_jax_estimate = jax.jit(lambda src, dst, valid, key, use_h: jr.estimate(
    src, dst, valid, key, MotionEstimationSettings(hypotheses=32), use_homography=use_h,
    min_samples=8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=60, n_valid=48, outliers=8):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 64, size=(n, 2)).astype(np.float32)
    h = np.array([[1.01, 0.02, 1.5], [-0.015, 0.99, -2.0], [1e-4, -2e-4, 1.0]], np.float32)
    ph = np.concatenate([src, np.ones((n, 1), np.float32)], 1) @ h.T
    dst = (ph[:, :2] / ph[:, 2:3] + rng.normal(0, 0.3, size=(n, 2))).astype(np.float32)
    dst[:outliers] += rng.uniform(10, 20, size=(outliers, 2)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    return src, dst, valid


@pytest.mark.parametrize(
    "case,use_h,n_valid",
    [("homography", True, 48), ("similarity", False, 48), ("too_few", True, 5)],
)
def test_estimate_matches_jax_with_injected_indices(case, use_h, n_valid):
    """(e) The same (K, 4) minimal sets (drawn by the very call at
    ransac.py:206-207): the final model maps the frame corners within
    1e-2 px, the inlier masks and `ok` are equal."""
    src, dst, valid = _problem(11, n_valid=n_valid)
    settings = MotionEstimationSettings(hypotheses=32)
    key = jax.random.key(3)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits, shape=(settings.hypotheses, 4)))
    ej = _jax_estimate(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key, jnp.asarray(use_h))
    et = tr.estimate(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), None,
                     tcfg.MotionEstimationSettings(hypotheses=32), use_homography=use_h,
                     min_samples=8, indices=torch.from_numpy(idx))
    corners = np.array([[0, 0], [63, 0], [0, 47], [63, 47]], np.float32)
    cj = np.asarray(JH(m=ej.homography.m).transform(jnp.asarray(corners)))
    ct = et.homography.transform(torch.from_numpy(corners)).numpy()
    assert np.abs(ct - cj).max() <= 1e-2
    np.testing.assert_array_equal(et.inliers.numpy(), np.asarray(ej.inliers))
    assert bool(et.ok) == bool(ej.ok)
    assert bool(et.ok) == (case != "too_few")


def test_sampler_draws_only_valid_indices():
    """The port's own sampler: uniform over valid features, on the device."""
    valid = torch.zeros(60, dtype=torch.bool)
    valid[torch.tensor([3, 17, 18, 40, 59])] = True
    gen = torch.Generator().manual_seed(0)
    idx = tr.sample_indices(valid, 256, gen)
    assert idx.shape == (256, 4)
    assert bool(valid[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=60)[valid]
    assert int(counts.min()) > 150  # 1024 draws over 5 features: ~205 each
