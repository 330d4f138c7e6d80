"""The port's stabilized trajectory against the OpenCV pipeline oracle of
tools/oracle_pipeline.py (the reference's numerics: goodFeaturesToTrack,
calcOpticalFlowPyrLK, USAC_MAGSAC findHomography and a centered Gaussian
window), in homography and in field (16x16 mesh) mode, on the tool's own
fixture clip and settings: jitter and ATE of the output path within 1.25x
of the oracle's (the ORACLE_TRAJECTORY*.json bound).  The oracle runs are
slow tests; the tier-1 test checks the port's smoother window against the
oracle's Gaussian weights."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.utils import metrics
from livevisionkit_tpu_torch.vision import path_smoother

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "oracle_pipeline.py")


def _oracle_module():
    spec = importlib.util.spec_from_file_location("oracle_pipeline", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tools/oracle_pipeline.py's fixture and settings (:153-169, :183-184, :203-231).
SIZE, N, PREDICTIVE, DETECTION = (160, 216), 60, 5, (120, 168)
SIGMA = PREDICTIVE / 2.0
BOUND = 1.25


def test_smoother_window_is_the_oracle_gaussian():
    """With its sigma pinned (min_sigma = max_sigma, as the tool pins it)
    the port's path smoother weighs a full window by the oracle's centered
    Gaussian `gaussian_weights(N, sigma)`: an impulse in the path shows each
    weight in turn, within 1e-6."""
    want = _oracle_module().gaussian_weights(PREDICTIVE, SIGMA)
    s = tcfg.PathSmootherSettings(predictive_samples=PREDICTIVE, min_sigma=SIGMA, max_sigma=SIGMA)
    a = 0.01
    k = 3 * PREDICTIVE  # the impulse's frame, once the window is full
    state = path_smoother.init(s, (2, 2), device="cpu")
    got = {}
    for t in range(k + 2 * PREDICTIVE + 1):
        m = a if t == k else (-a if t == k + 1 else 0.0)
        state, corr, _ = path_smoother.next_correction(
            state, lt.WarpField(offsets=torch.full((2, 2, 2), m)), s)
        anchor = t - PREDICTIVE
        if anchor >= 2 * PREDICTIVE and anchor != k:
            got[k - anchor] = float(corr.offsets[0, 0, 0]) / a
    offsets = sorted(got)
    np.testing.assert_allclose([got[d] for d in offsets], want[[d + PREDICTIVE for d in offsets]],
                               rtol=0, atol=1e-6)
    assert len(offsets) == 2 * PREDICTIVE


def _clip():
    """The tool's fixture: seed 11, a 420x420 texture, a low-drift shaky
    path (margin 110, drift 0.1 px, shake 2.5 px), 60 gray 160x216 frames."""
    rng = np.random.default_rng(11)
    base = fixtures.make_texture(420, 420, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=110.0, drift_px=0.1, shake_px=2.5)
    frames = [np.asarray(fixtures.render_frame(base, p, SIZE)) for p in poses]
    return poses, frames


def _field_at(c, xt):
    """(dx, dy) pixel offset of a (2, gh, gw) normalized field at (x, y),
    bilinear in the grid, as the tool reads the JAX stabilizer's."""
    h, w = SIZE
    gh, gw = c.shape[1:]
    fy = np.clip(xt[1] / (h - 1) * (gh - 1), 0, gh - 1)
    fx = np.clip(xt[0] / (w - 1) * (gw - 1), 0, gw - 1)
    y0, x0 = int(fy), int(fx)
    y1, x1 = min(y0 + 1, gh - 1), min(x0 + 1, gw - 1)
    wy, wx = fy - y0, fx - x0
    v = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x1] * (1 - wy) * wx
         + c[:, y1, x0] * wy * (1 - wx) + c[:, y1, x1] * wy * wx)
    return np.array([v[1] * (w - 1), v[0] * (h - 1)])


@pytest.mark.slow
@pytest.mark.parametrize("model", ["homography", "field"])
def test_port_trajectory_within_oracle_bound(model):
    """The port's stabilizer (its sigma pinned to the oracle's, in `model`
    mode) and the OpenCV oracle on the same clip: over the tool's steady
    window (t >= 25) the port's output jitter and ATE against the smoothed
    input are at most 1.25x the oracle's."""
    cv2 = pytest.importorskip("cv2")
    oracle = _oracle_module()
    poses, frames = _clip()
    frames_u8 = [np.clip(f * 255 + 0.5, 0, 255).astype(np.uint8) for f in frames]
    scene = np.array([[210.0, 205.0]], np.float32)
    x_in = np.array([np.asarray(p.inverse().transform(scene))[0] for p in poses])
    oracle_corr = oracle.oracle_stabilize(frames_u8, PREDICTIVE, SIGMA, 0.10, detection_size=DETECTION)

    mesh = {}
    if model == "field":
        mesh = dict(motion_resolution=(16, 16), mesh=tcfg.MeshMotionSettings(inlier_threshold_px=10.0))
    filt = lt.StabilizationFilter(settings=tcfg.StabilizationFilterSettings(
        tracker=tcfg.FrameTrackerSettings(
            detection_size=DETECTION,
            detector=tcfg.FeatureDetectorSettings(grid_shape=(10, 14), fast_threshold_init=0.06),
            min_motion_samples=15, **mesh),
        smoother=tcfg.PathSmootherSettings(predictive_samples=PREDICTIVE, min_sigma=SIGMA,
                                           max_sigma=SIGMA),
    ))
    state = filt.init(lt.FrameSpec(*SIZE, 1, lt.PixelFormat.GRAY), device="cpu")
    corr, valid = [], []
    for t, f in enumerate(frames):
        frame = lt.Frame.create(torch.from_numpy(np.array(f))[None], timestamp=t / 30.0,
                                fmt=lt.PixelFormat.GRAY)
        state, out = filt.step(state, frame)
        corr.append(state.correction.offsets.numpy())
        valid.append(bool(out.valid))

    t0 = max(2 * PREDICTIVE, 25)  # the tool's steady-state window
    x_sel, y_oracle, y_port = [], [], []
    for t in range(t0, N):
        assert valid[t]
        xt = x_in[t - PREDICTIVE]
        x_sel.append(xt)
        y_oracle.append(cv2.perspectiveTransform(np.asarray(xt, np.float64).reshape(1, 1, 2),
                                                 oracle_corr[t])[0, 0])
        y_port.append(xt - _field_at(corr[t], xt))
    x_sel, y_oracle, y_port = map(np.asarray, (x_sel, y_oracle, y_port))
    ideal = metrics.smooth_path(x_sel, sigma=SIGMA)
    jitter = metrics.jitter(y_port) / max(metrics.jitter(y_oracle), 1e-9)
    ate = metrics.ate(y_port, ideal) / max(metrics.ate(y_oracle, ideal), 1e-9)
    assert metrics.jitter(y_port) < metrics.jitter(x_sel)
    assert jitter <= BOUND and ate <= BOUND, (model, jitter, ate)
