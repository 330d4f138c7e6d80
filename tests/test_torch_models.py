"""Port parity: models (homography, warp field), FAST features and the path
smoother."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livevisionkit_tpu.config import FeatureDetectorSettings, PathSmootherSettings
from livevisionkit_tpu.models import homography as jh
from livevisionkit_tpu.models import warp_field as jwf
from livevisionkit_tpu.vision import features as jfeat
from livevisionkit_tpu.vision import path_smoother as jps
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.models import homography as th
from livevisionkit_tpu_torch.models import warp_field as twf
from livevisionkit_tpu_torch.vision import features as tfeat
from livevisionkit_tpu_torch.vision import path_smoother as tps

# rtol 1e-4 on model entries; atol 1e-6 for the near-zero perspective terms.
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _similarity_pair(scale, angle, tx, ty):
    f = np.float32
    return (jh.Homography.from_similarity(f(scale), f(angle), f(tx), f(ty)),
            th.Homography.from_similarity(*(torch.tensor(f(v)) for v in (scale, angle, tx, ty))))


def _quads(rng, k=16):
    src = rng.uniform(4, 60, size=(k, 4, 2)).astype(np.float32)
    dst = (src + rng.normal(0, 1.5, size=src.shape)).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("case", ["batched", "single"])
def test_dlt4_matches_jax(case):
    """(c) rtol 1e-4."""
    src, dst = _quads(np.random.default_rng(0))
    if case == "single":
        src, dst = src[0], dst[0]
    want = np.asarray(jh.dlt4(jnp.asarray(src), jnp.asarray(dst)))
    got = th.dlt4(_t(src), _t(dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("inverse", [True, False])
def test_homography_sample_map_matches_jax(inverse):
    """(c) rtol 1e-4 on pixel coordinates (atol 1e-4 px near 0)."""
    hj, ht = _similarity_pair(1.02, 0.01, 3.0, -2.0)
    want = np.asarray(hj.sample_map((48, 64), inverse=inverse))
    got = ht.sample_map((48, 64), inverse=inverse).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_warp_field_from_homography_and_back():
    """(c) from_homography and to_homography, rtol 1e-4."""
    hj, ht = _similarity_pair(0.99, -0.02, -4.0, 5.0)
    fj = jwf.WarpField.from_homography(hj, (2, 2), (48, 64))
    ft = twf.WarpField.from_homography(ht, (2, 2), (48, 64))
    np.testing.assert_allclose(ft.offsets.numpy(), np.asarray(fj.offsets), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ft.to_homography((48, 64)).m.numpy(), np.asarray(fj.to_homography((48, 64)).m),
        rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("op", ["compose", "clamp", "algebra"])
def test_warp_field_ops_match_jax(op):
    """(c) rtol 1e-4."""
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.05, 0.05, size=(2, 2, 2)).astype(np.float32)
    b = rng.uniform(-0.05, 0.05, size=(2, 2, 2)).astype(np.float32)
    ja, jb = jwf.WarpField(offsets=jnp.asarray(a)), jwf.WarpField(offsets=jnp.asarray(b))
    ta, tb = twf.WarpField(offsets=_t(a)), twf.WarpField(offsets=_t(b))
    if op == "compose":
        want, got = ja.compose(jb).offsets, ta.compose(tb).offsets
    elif op == "clamp":
        want, got = ja.clamp(0.02, 0.03).offsets, ta.clamp(0.02, 0.03).offsets
    else:
        want, got = (ja + jb * 0.5 - ja).offsets, (ta + tb * 0.5 - ta).offsets
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _corner_image(rng, h=48, w=64):
    img = rng.uniform(0.3, 0.5, size=(h, w)).astype(np.float32)
    for _ in range(12):
        y, x = rng.integers(2, h - 10), rng.integers(2, w - 10)
        img[y:y + 6, x:x + 6] = rng.choice([0.05, 0.95])
    return img


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_score_map_matches_jax(seed):
    """(c) atol 1e-6."""
    img = _corner_image(np.random.default_rng(seed))
    want = np.asarray(jfeat.fast_score_map(jnp.asarray(img), jnp.float32(0.1)))
    got = tfeat.fast_score_map(_t(img), torch.tensor(0.1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_prev", [False, True])
def test_detect_matches_jax(with_prev):
    """(c) detect: same points and valid flags; thresholds servo equal."""
    rng = np.random.default_rng(3)
    img = _corner_image(rng)
    js, ts = FeatureDetectorSettings(grid_shape=(4, 4)), tcfg.FeatureDetectorSettings(grid_shape=(4, 4))
    thr = np.full((2, 2), 0.08, np.float32)
    prev_j = prev_t = None
    if with_prev:
        pts = rng.uniform(0, 60, size=(16, 2)).astype(np.float32)
        sc = rng.uniform(0, 1, size=16).astype(np.float32)
        va = rng.uniform(size=16) > 0.5
        prev_j = jfeat.FeatureGrid(points=jnp.asarray(pts), scores=jnp.asarray(sc), valid=jnp.asarray(va))
        prev_t = tfeat.FeatureGrid(points=_t(pts), scores=_t(sc), valid=_t(va))
    fj, thj = jfeat.detect(jnp.asarray(img), jnp.asarray(thr), js, prev_features=prev_j)
    ft, tht = tfeat.detect(_t(img), _t(thr), ts, prev_features=prev_t)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.points.numpy(), np.asarray(fj.points))
    np.testing.assert_allclose(ft.scores.numpy(), np.asarray(fj.scores), atol=1e-6)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), atol=1e-7)


def test_rebin_matches_jax():
    """(c) rebin: same winners per cell, ties to the lowest slot."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 66, size=(16, 2)).astype(np.float32)
    pts[5] = pts[3]  # an exact tie in one cell
    sc = rng.uniform(0, 1, size=16).astype(np.float32)
    sc[5] = sc[3]
    va = rng.uniform(size=16) > 0.2
    js, ts = FeatureDetectorSettings(grid_shape=(4, 4)), tcfg.FeatureDetectorSettings(grid_shape=(4, 4))
    gj = jfeat.rebin(jnp.asarray(pts), jnp.asarray(sc), jnp.asarray(va), js, (48, 64))
    gt = tfeat.rebin(_t(pts), _t(sc), _t(va), ts, (48, 64))
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
    np.testing.assert_array_equal(gt.points.numpy(), np.asarray(gj.points))
    np.testing.assert_array_equal(gt.scores.numpy(), np.asarray(gj.scores))


def test_distribution_quality_matches_jax():
    """(c) atol 1e-5 over 8 random point sets."""
    rng = np.random.default_rng(5)
    for _ in range(8):
        pts = rng.uniform(0, 64, size=(16, 2)).astype(np.float32)
        va = rng.uniform(size=16) > 0.3
        want = float(jfeat.distribution_quality(jnp.asarray(pts), jnp.asarray(va), (48, 64)))
        got = float(tfeat.distribution_quality(_t(pts), _t(va), (48, 64)))
        assert abs(got - want) <= 1e-5


def test_path_smoother_matches_jax_over_8_steps():
    """(c) next_correction: correction, ready and the servo scalars agree
    within 1e-5 over 8 steps of random motion."""
    rng = np.random.default_rng(6)
    js, ts = PathSmootherSettings(predictive_samples=2), tcfg.PathSmootherSettings(predictive_samples=2)
    sj, st = jps.init(js, (2, 2)), tps.init(ts, (2, 2), device="cpu")
    for _ in range(8):
        m = rng.normal(0, 0.02, size=(2, 2, 2)).astype(np.float32)
        sj, cj, rj = jps.next_correction(sj, jwf.WarpField(offsets=jnp.asarray(m)), js)
        st, ct, rt = tps.next_correction(st, twf.WarpField(offsets=_t(m)), ts)
        np.testing.assert_allclose(ct.offsets.numpy(), np.asarray(cj.offsets), atol=1e-5, rtol=0)
        assert bool(rt) == bool(rj)
        assert abs(float(st.smoothing) - float(sj.smoothing)) <= 1e-5
        assert abs(float(st.drift_ema) - float(sj.drift_ema)) <= 1e-5


# ------------------------------------------------------------ the last missing methods


def test_homography_constructors_and_normalized_match_jax():
    """identity, from_matrix (array and tensor), from_affine and normalized
    equal to the JAX package's (exact: the same float32 operations)."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(3, 3)).astype(np.float32) + np.eye(3, dtype=np.float32) * 2
    a = rng.normal(size=(2, 3)).astype(np.float32)
    assert np.array_equal(th.Homography.identity(device="cpu").m.numpy(),
                          np.asarray(jh.Homography.identity().m))
    for src in (m, torch.from_numpy(m)):
        got = th.Homography.from_matrix(src)
        assert got.m.dtype == torch.float32 and np.array_equal(got.m.numpy(), m)
    for src in (a, torch.from_numpy(a)):
        np.testing.assert_array_equal(th.Homography.from_affine(src).m.numpy(),
                                      np.asarray(jh.Homography.from_affine(jnp.asarray(a)).m))
    np.testing.assert_allclose(th.Homography.from_matrix(m).normalized().m.numpy(),
                               np.asarray(jh.Homography.from_matrix(m).normalized().m),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("skip", [0, 2, 9, "tensor"])
def test_stream_buffer_skip_clear_newest_centre_match_jax(skip):
    """After 1..7 pushes into a 5-slot buffer: oldest, newest and centre,
    then skip(n) (an int, or a 0-d tensor of 3) and clear, all equal to the
    JAX package's StreamBuffer."""
    from livevisionkit_tpu.data.stream_buffer import StreamBuffer as JB
    from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer as TB

    jb = JB.create({"x": jnp.zeros((2,), jnp.float32)}, 5)
    tb = TB.create({"x": torch.zeros(2)}, 5)
    for i in range(7):
        v = np.float32([i, -i])
        jb, tb = jb.push({"x": jnp.asarray(v)}), tb.push({"x": torch.from_numpy(v)})
        for name in ("oldest", "newest", "centre"):
            assert np.array_equal(getattr(tb, name)()["x"].numpy(),
                                  np.asarray(getattr(jb, name)()["x"])), (i, name)
        n_j, n_t = (jnp.int32(3), torch.tensor(3)) if skip == "tensor" else (skip, skip)
        js, ts = jb.skip(n_j), tb.skip(n_t)
        assert (int(ts.start), int(ts.count)) == (int(js.start), int(js.count)), i
        if int(js.count):
            assert np.array_equal(ts.oldest()["x"].numpy(), np.asarray(js.oldest()["x"]))
    jc, tc = jb.clear(), tb.clear()
    assert (int(tc.start), int(tc.count)) == (int(jc.start), int(jc.count)) == (0, 0)


def test_frame_spec_size_and_feature_grid_counts_match_jax():
    from livevisionkit_tpu.filters.base import FrameSpec as JSpec
    from livevisionkit_tpu_torch.filters.base import FrameSpec as TSpec

    assert TSpec(48, 64, 1).size == JSpec(48, 64, 1).size == (48, 64)
    rng = np.random.default_rng(8)
    pts = rng.uniform(0, 60, size=(24, 2)).astype(np.float32)
    sc = rng.uniform(size=24).astype(np.float32)
    va = rng.uniform(size=24) > 0.4
    jg = jfeat.FeatureGrid(points=jnp.asarray(pts), scores=jnp.asarray(sc), valid=jnp.asarray(va))
    tg = tfeat.FeatureGrid(points=_t(pts), scores=_t(sc), valid=_t(va))
    assert tg.capacity == jg.capacity == 24
    assert int(tg.count()) == int(jg.count()) == int(va.sum())
