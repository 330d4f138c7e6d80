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


# K4's inputs (tests/test_pallas_lk.py::_setup, the conftest's seed): (case,
# shift of the next frame, points: None for _setup's interior ones, or
# border points whose windows leave the frame, initial flow).
_W, _H = 120, 68
_BORDER_PTS = [[1.2, 3.4], [_W - 2.0, 2.0], [3.0, _H - 1.5], [0.4, 0.7], [_W - 1.2, _H - 1.1],
               [0.0, 30.5], [60.25, 0.0], [_W - 1.0, 40.75], [55.5, _H - 1.0]]
_LEVEL_CASES = [
    ("interior", (1, -1), None, (0.0, 0.0)),
    ("border", (1, -1), _BORDER_PTS, (0.0, 0.0)),
    ("shift_down", (0, 1), None, (0.0, 0.0)),
    ("warm_start", (1, -1), None, (0.6, -0.7)),
]


@pytest.mark.parametrize("case", _LEVEL_CASES, ids=lambda c: c[0])
def test_one_level_matches_jax_track_level(case):
    """K4's counterpart: the port's one-level LK (`track_plain` on
    one-level pyramids, what the kernel's n_levels = 1 call is held
    against) against JAX's `_track_level`, on test_pallas_lk's inputs.
    Flow within 1e-3 px on every feature (the same samples and sums in
    another order; the motions stay inside JAX's 4 px drift window) and
    equal masks."""
    from test_pallas_lk import _setup

    _, shift, border, guess0 = case
    prev, nxt, pts = _setup(np.random.default_rng(42), shift=shift)
    if border is not None:
        pts = jax.numpy.asarray(np.array(border, np.float32))
    guess = jax.numpy.asarray(np.tile(np.array(guess0, np.float32), (pts.shape[0], 1)))
    f_j, g_j, _ = jof._track_level(prev, nxt, pts, guess, OpticalFlowSettings())

    one = lambda a: tof.Pyramid((torch.from_numpy(np.array(a)),))  # noqa: E731
    f_t, g_t = tof.track_plain(one(prev), one(nxt), torch.from_numpy(np.array(pts)),
                               tcfg.OpticalFlowSettings(), init_flow=torch.from_numpy(np.array(guess)))
    err = np.abs(f_t.numpy() - np.asarray(f_j)).max()
    assert err <= 1e-3, err
    assert np.array_equal(g_t.numpy(), np.asarray(g_j))
