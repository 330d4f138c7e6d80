"""Port parity: pyramidal LK (the plain version of the LK kernel) against
the JAX XLA path."""

import jax
import numpy as np
import pytest
import torch

import fixtures
from livevisionkit_tpu.config import FeatureDetectorSettings, OpticalFlowSettings
from livevisionkit_tpu.vision import features as jfeat
from livevisionkit_tpu.vision import optical_flow as jof
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.vision import optical_flow as tof


# One compiled JAX track (eager dispatch of its unrolled loops is slower).
_jax_track = jax.jit(lambda f0, f1, pts, valid: jof.track(
    jof.Pyramid.build(f0, 3), jof.Pyramid.build(f1, 3), pts, valid, OpticalFlowSettings()))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "motion",
    [(2.5, 1.25, 0.0), (-1.75, 2.0, 0.008), (0.6, -0.4, -0.01)],  # (dx, dy, angle)
)
def test_track_matches_jax(motion):
    """(d) A shifted and rotated texture at 96x128, 3 levels, the 8x8 grid
    features.  Flow agrees within 1e-3 px on features both mark tracked (the
    same samples and sums in another order) and the masks agree on >= 99%.
    The motions stay inside the JAX path's 4 px per-level drift window."""
    rng = np.random.default_rng(7)
    base = fixtures.make_texture(200, 240, rng)
    size = (96, 128)
    dx, dy, ang = motion
    f0 = fixtures.render_frame(base, fixtures.camera_pose(40.0, 40.0), size)
    f1 = fixtures.render_frame(base, fixtures.camera_pose(40.0 + dx, 40.0 + dy, ang), size)
    det = FeatureDetectorSettings(grid_shape=(8, 8), fast_threshold_init=0.06)
    feats, _ = jfeat.detect(f0, jfeat.initial_thresholds(det), det)
    new_j, tr_j = _jax_track(f0, f1, feats.points, feats.valid)

    tsettings = tcfg.OpticalFlowSettings()
    pt0 = tof.Pyramid.build(torch.from_numpy(np.array(f0)), 3)
    pt1 = tof.Pyramid.build(torch.from_numpy(np.array(f1)), 3)
    new_t, tr_t = tof.track(
        pt0, pt1, torch.from_numpy(np.array(feats.points)),
        torch.from_numpy(np.array(feats.valid)), tsettings,
    )
    tr_j, tr_t = np.asarray(tr_j), tr_t.numpy()
    valid = np.asarray(feats.valid)
    both = tr_j & tr_t
    assert both.sum() >= 20
    err = np.abs(new_t.numpy() - np.asarray(new_j))[both].max()
    assert err <= 1e-3, err
    assert (tr_j == tr_t)[valid].mean() >= 0.99
