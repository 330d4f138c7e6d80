"""Port parity of lens correction and calibration: `optimal_new_camera` and
`undistort_field` against the JAX package's, `LensCorrectionFilter.step`
in EASU and bilinear mode (with and without alpha) against the JAX step,
the chessboard response and detection, Zhang calibration, and the
`lvk-calibrate` CLI end to end."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu.models.homography import Homography as JH
from livevisionkit_tpu.vision import calibration as jcal
from livevisionkit_tpu.vision import chessboard as jchess
from livevisionkit_tpu_torch.models.homography import Homography as TH
from livevisionkit_tpu_torch.vision import calibration as tcal
from livevisionkit_tpu_torch.vision import chessboard as tchess

GT = dict(fx=420.0, fy=410.0, cx=160.0, cy=120.0, k1=-0.25, k2=0.07, p1=0.001, p2=-0.001)
SIZE = (240, 320)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_optimal_new_camera_and_undistort_field_match_jax(alpha):
    """Both are host float64 numpy in each package: equal within 1e-6."""
    want_k = jcal.optimal_new_camera(jcal.CameraParameters(**GT), SIZE, alpha)
    got_k = tcal.optimal_new_camera(tcal.CameraParameters(**GT), SIZE, alpha)
    np.testing.assert_allclose(got_k.matrix, want_k.matrix, atol=1e-6, rtol=0)
    want = jcal.undistort_field(jcal.CameraParameters(**GT), SIZE, (17, 25), alpha)
    got = tcal.undistort_field(tcal.CameraParameters(**GT), SIZE, (17, 25), alpha, device="cpu")
    assert got.offsets.dtype == torch.float32 and got.offsets.shape == (2, 17, 25)
    np.testing.assert_allclose(got.offsets.numpy(), np.asarray(want.offsets), atol=1e-6, rtol=0)


def _frame_pair(fmt, alpha, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    c = 1 if fmt == "GRAY" else 3
    px = rng.uniform(0.2, 0.8, size=(c, *size)).astype(np.float32)
    px[:, 60:100, 80:150] = 0.95  # hard edges for EASU's edge-adaptive path
    a = rng.uniform(0, 1, size=size).astype(np.float32) if alpha else None
    jf = lj.Frame.create(jnp.asarray(px), fmt=getattr(lj.PixelFormat, fmt),
                         alpha=None if a is None else jnp.asarray(a))
    tf = lt.Frame.create(torch.from_numpy(px), fmt=getattr(lt.PixelFormat, fmt),
                         alpha=None if a is None else torch.from_numpy(a))
    return jf, tf


@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("fmt,alpha", [("YUV", False), ("YUV", True), ("GRAY", False)])
def test_lens_correction_step_matches_jax(mode, fmt, alpha):
    """The undistort warp against the JAX step, within the warp bounds of
    tests/test_pallas_warp.py: bilinear max < 1e-3 (:64-78), EASU q99.9 <
    2e-2 and mean < 1e-3 (:288-311); the alpha plane, warped in the same
    gather, likewise."""
    jfilt = lj.LensCorrectionFilter(parameters=lj.CameraParameters(**GT), warp_filter=mode)
    tfilt = lt.LensCorrectionFilter(parameters=lt.CameraParameters(**GT), warp_filter=mode)
    jf, tf = _frame_pair(fmt, alpha)
    jstate = jfilt.init(lj.FrameSpec(*SIZE, jf.channels, jf.format, has_alpha=alpha))
    tstate = tfilt.init(lt.FrameSpec(*SIZE, tf.channels, tf.format, has_alpha=alpha), device="cpu")
    _, jout = jfilt.step(jstate, jf)
    _, tout = tfilt.step(tstate, tf)
    pairs = [(tout.pixels.numpy(), np.asarray(jout.pixels))]
    assert (tout.alpha is None) == (not alpha)
    if alpha:
        pairs.append((tout.alpha.numpy(), np.asarray(jout.alpha)))
    for got, want in pairs:
        assert got.shape == want.shape
        err = np.abs(got - want)
        if mode == "bilinear":
            assert err.max() < 1e-3, err.max()
        else:
            assert np.quantile(err, 0.999) < 2e-2 and err.mean() < 1e-3, (err.max(), err.mean())


def _board_image(pose, pattern=(9, 6), square=24, size=SIZE):
    """A chessboard rendered through the homography `pose` (the JAX test's
    renderer, tests/test_calibration.py::_render_board, on the port)."""
    cols, rows = pattern
    h, w = size
    yy, xx = np.mgrid[0:(rows + 1) * square, 0:(cols + 1) * square]
    board = 0.15 + 0.7 * (((yy // square) + (xx // square)) % 2).astype(np.float32)
    canvas = np.full((h, w), 0.5, np.float32)
    canvas[: board.shape[0], : board.shape[1]] = board
    img = TH(m=torch.from_numpy(pose.astype(np.float32))).warp(torch.from_numpy(canvas), fill=0.5)
    corners = np.stack(np.meshgrid((np.arange(cols) + 1) * square, (np.arange(rows) + 1) * square),
                       -1).reshape(-1, 2).astype(np.float64)
    ph = np.c_[corners, np.ones(len(corners))] @ pose.T
    return img.numpy(), ph[:, :2] / ph[:, 2:]


POSE = np.array([[0.9, 0.05, 40.0], [-0.04, 0.92, 30.0], [1e-5, 2e-5, 1.0]])


def test_chess_response_matches_jax():
    img, _ = _board_image(POSE)
    want = np.asarray(jchess.chess_response(jnp.asarray(img)))
    got = tchess.chess_response(torch.from_numpy(img)).numpy()
    assert (want > 0.05).sum() > 54
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_find_chessboard_matches_jax():
    """Both packages find the same 54 corners in the same order (within
    1e-4 px: the sub-pixel fit reads responses that agree to 1e-5), each
    within 2 px of the rendered corner."""
    img, gt = _board_image(POSE)
    want = jchess.find_chessboard(img, pattern=(9, 6))
    got = tchess.find_chessboard(torch.from_numpy(img), pattern=(9, 6))
    assert want is not None and got is not None and got.shape == (54, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    from scipy.spatial import cKDTree

    d, idx = cKDTree(gt).query(got)
    assert d.max() < 2.0 and len(np.unique(idx)) == 54
    assert tchess.find_chessboard(np.full(SIZE, 0.5, np.float32)) is None


def _synth_views(rng, n_views=8, pattern=(7, 5)):
    """A planar board projected through GT at random poses, with 0.05 px
    noise (tests/test_calibration.py::_synth_views)."""
    cols, rows = pattern
    obj = np.stack(np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows)), -1).reshape(-1, 2)
    gt = tcal.CameraParameters(**GT)
    views_obj, views_img = [], []
    while len(views_obj) < n_views:
        rvec = rng.uniform(-0.3, 0.3, 3)
        tvec = np.array([rng.uniform(-1.5, 0.5), rng.uniform(-1.2, 0.2), rng.uniform(8, 14)])
        proj = tcal._project(np.array([gt.fx, gt.fy, gt.cx, gt.cy, gt.k1, gt.k2, gt.p1, gt.p2, gt.k3]),
                             np.c_[obj, np.zeros(len(obj))], rvec, tvec)
        if (proj[:, 0].min() < 5 or proj[:, 0].max() > SIZE[1] - 5
                or proj[:, 1].min() < 5 or proj[:, 1].max() > SIZE[0] - 5):
            continue
        views_obj.append(obj)
        views_img.append(proj + rng.normal(0, 0.05, proj.shape))
    return views_obj, views_img


def test_calibrate_recovers_intrinsics_as_jax_does():
    """The JAX test's bounds (tests/test_calibration.py:45-53), and the same
    estimate as the JAX package's calibrate (both host float64)."""
    objs, imgs = _synth_views(np.random.default_rng(42))
    est, rms = tcal.calibrate(objs, imgs, SIZE)
    assert rms < 0.2, rms
    assert abs(est.fx - GT["fx"]) / GT["fx"] < 0.02 and abs(est.fy - GT["fy"]) / GT["fy"] < 0.02
    assert abs(est.cx - GT["cx"]) < 5 and abs(est.cy - GT["cy"]) < 5
    assert abs(est.k1 - GT["k1"]) < 0.05
    jest, jrms = jcal.calibrate(objs, imgs, SIZE)
    np.testing.assert_allclose(list(est.to_dict().values()), list(jest.to_dict().values()),
                               rtol=1e-9, atol=1e-12)
    assert abs(rms - jrms) < 1e-9


def test_calibrate_cli_end_to_end(tmp_path):
    """Chessboard video -> profile JSON -> a lens-correction filter, on the
    CPU (the JAX test's clip: 30 frames of a 7x5 board, rotated, scaled and
    tilted)."""
    cv2 = pytest.importorskip("cv2")
    from livevisionkit_tpu_torch.runtime import calibrate_cli

    src = str(tmp_path / "board.avi")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30, (320, 240))
    assert w.isOpened()
    for t in range(30):
        ang, sc = 0.15 * np.sin(t / 4.0), 0.85 + 0.1 * np.cos(t / 5.0)
        c, s = sc * np.cos(ang), sc * np.sin(ang)
        pose = np.array([[c, -s, 30.0 + 6 * t], [s, c, 25.0 + 2.5 * t],
                         [8e-4 * np.sin(t / 3.0), 8e-4 * np.cos(t / 3.5), 1.0]])
        img, _ = _board_image(pose, pattern=(7, 5), square=22)
        w.write(np.repeat((img * 255).astype(np.uint8)[:, :, None], 3, 2))
    w.release()
    out = str(tmp_path / "profile.json")
    rc = calibrate_cli.main([src, out, "--pattern", "7x5", "--captures", "5", "--every", "3",
                             "--device", "cpu"])
    assert rc == 0
    prof = json.load(open(out))
    assert set(prof) == {"fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"}
    assert 50 < prof["fx"] < 5000 and 50 < prof["fy"] < 5000
    filt = lt.LensCorrectionFilter(parameters=lt.CameraParameters.from_dict(prof))
    state = filt.init(lt.FrameSpec(240, 320, 1, lt.PixelFormat.GRAY), device="cpu")
    assert state.offsets.shape == (2, 33, 33)
