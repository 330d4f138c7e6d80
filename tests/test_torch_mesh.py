"""Port parity of mesh (vector-field) mode on the CPU, against the JAX
package: the corner-aligned resize and Scharr gradients, every WarpField
method, Quad, the mesh solve (its gather, its adjoint scatter and whole
solves), and the mesh stabilizer over a fixture clip with a JAX state
carried into the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.models import homography as jh
from livevisionkit_tpu.models import quad as jquad
from livevisionkit_tpu.models import warp_field as jwf
from livevisionkit_tpu.ops import resample as jres
from livevisionkit_tpu.vision import mesh_motion as jmm
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch.models import homography as th
from livevisionkit_tpu_torch.models import quad as tquad
from livevisionkit_tpu_torch.models import warp_field as twf
from livevisionkit_tpu_torch.ops import resample as tres
from livevisionkit_tpu_torch.utils import metrics
from livevisionkit_tpu_torch.vision import mesh_motion as tmm

# Offsets and field algebra: rtol 1e-4, atol 1e-6 (as tests/test_torch_models.py).
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ resample ops

RESIZE_CASES = {"mesh_to_frame": ((2, 9, 11), (48, 64)), "2x2_to_mesh": ((2, 2, 2), (16, 16)),
                "mesh_down": ((2, 16, 16), (9, 5)), "lead_axes": ((2, 3, 4, 6), (7, 9))}


@pytest.mark.parametrize("name", list(RESIZE_CASES))
def test_resize_corner_aligned_matches_jax(name):
    """Within 1e-5 of JAX's scale_and_translate form, values in [-1, 1]."""
    shape, size = RESIZE_CASES[name]
    x = np.random.default_rng(0).uniform(-1, 1, size=shape).astype(np.float32)
    want = np.asarray(jres.resize_corner_aligned(jnp.asarray(x), size))
    got = tres.resize_corner_aligned(_t(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., 0, 0], x[..., 0, 0])  # corners map onto corners


def test_resize_corner_aligned_rejects_one_sample_axis():
    with pytest.raises(ValueError, match=">= 2 samples"):
        tres.resize_corner_aligned(torch.zeros(2, 1, 5), (4, 8))


def test_scharr_gradients_match_jax():
    """(dx, dy) within 1e-5 of JAX's, reflect-101 borders included."""
    x = np.random.default_rng(1).uniform(size=(3, 40, 56)).astype(np.float32)
    for got, want in zip(tres.scharr_gradients(_t(x)), jres.scharr_gradients(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ------------------------------------------------------------ WarpField

FRAME = (48, 64)


def _fields():
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.03, 0.03, size=(2, 9, 11)).astype(np.float32)
    b = rng.uniform(-0.03, 0.03, size=(2, 9, 11)).astype(np.float32)
    c = rng.uniform(-0.05, 0.05, size=(2, 2, 2)).astype(np.float32)
    return a, b, c


def _image(dtype):
    rng = np.random.default_rng(3)
    img = np.stack([np.asarray(fixtures.make_texture(*FRAME, rng)) for _ in range(3)])
    if dtype == "uint8":
        return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return img.astype(np.float32)


# name -> fn(WarpField cls, a, b, c) -> offsets-like result, for either package.
FIELD_OPS = {
    "neg": lambda W, a, b, c: (-W(offsets=a)).offsets,
    "lerp": lambda W, a, b, c: W(offsets=a).lerp(W(offsets=b), 0.3).offsets,
    "scale": lambda W, a, b, c: W(offsets=a).scale((1.1, 0.9)).offsets,
    "crop_in": lambda W, a, b, c: W(offsets=a).crop_in((0.1, 0.2), (0.5, 0.6)).offsets,
    "rotate": lambda W, a, b, c: W(offsets=a).rotate(7.0).offsets,
    "magnitude": lambda W, a, b, c: W(offsets=a).magnitude(),
    "resize_up": lambda W, a, b, c: W(offsets=a).resize((16, 20)).offsets,
    "resize_down": lambda W, a, b, c: W(offsets=a).resize((4, 5)).offsets,
    "compose_equal": lambda W, a, b, c: W(offsets=a).compose(W(offsets=b)).offsets,
    "compose_mesh_after_2x2": lambda W, a, b, c: W(offsets=a).compose(W(offsets=c)).offsets,
    "compose_2x2_after_mesh": lambda W, a, b, c: W(offsets=c).compose(W(offsets=a)).offsets,
    "sample_map": lambda W, a, b, c: W(offsets=a).sample_map(FRAME),
    "covers": lambda W, a, b, c: [
        W(offsets=x * k).covers(tl, br, FRAME) for x in (a, c) for k in (1.0, 4.0)
        for tl, br in (((0.0, 0.0), (1.0, 1.0)), ((0.1, 0.1), (0.9, 0.9)))],
}
# apply on a non-2x2 field, through the dense sample map: (filter, dtype).
APPLY_CASES = [(m, d) for m in ("easu", "bilinear") for d in ("float32", "uint8")]


def _warp_bounds(got, want, mode, dtype):
    """The tolerances of tests/test_pallas_warp.py: EASU f32 q99.9 < 2e-2
    and mean < 1e-3; bilinear f32 < 1e-3; u8 max <= 6 and mean < 1."""
    if dtype == "uint8":
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 6 and d.mean() < 1.0, (d.max(), d.mean())
    elif mode == "easu":
        d = np.abs(got - want)
        assert np.quantile(d, 0.999) < 2e-2 and d.mean() < 1e-3, (np.quantile(d, 0.999), d.mean())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", list(FIELD_OPS) + [f"apply_{m}_{d}" for m, d in APPLY_CASES])
def test_warp_field_methods_match_jax(case):
    """Every WarpField method of the port against the JAX package's on the
    same (2, 9, 11) and (2, 2, 2) fields: offsets within rtol 1e-4 / atol
    1e-6, sample maps within 1e-4 px, `covers` equal, and a non-2x2 `apply`
    (dense map, fill 0) within the warp tolerances of
    tests/test_pallas_warp.py."""
    a, b, c = _fields()
    if case.startswith("apply_"):
        _, mode, dtype = case.split("_")
        img = _image(dtype)
        want = np.asarray(jwf.WarpField(offsets=jnp.asarray(a)).apply(
            jnp.asarray(img), fill=0.0, exact_2x2=False, filter_mode=mode, fmt=lj.PixelFormat.YUV))
        got = twf.WarpField(offsets=_t(a)).apply(_t(img), fill=0.0, exact_2x2=False,
                                                 filter_mode=mode, fmt=lt.PixelFormat.YUV).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        _warp_bounds(got, want, mode, dtype)
        return
    want = FIELD_OPS[case](jwf.WarpField, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = FIELD_OPS[case](twf.WarpField, _t(a), _t(b), _t(c))
    if case == "covers":
        assert [bool(g) for g in got] == [bool(w) for w in want]
        assert len(set(bool(g) for g in got)) == 2  # the cases cover both answers
    elif case == "sample_map":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dense_apply_follows_2x2_homography():
    """A 2x2 field applied through its dense map (exact_2x2=False) lands on
    the exact homography warp away from the border (bilinear, as
    tests/test_warp_field.py's dense translation)."""
    img = _t(_image("float32"))
    h = th.Homography.from_similarity(*(torch.tensor(v) for v in (1.0, 0.0, 2.0, 3.0)))
    f = twf.WarpField.from_homography(h, (2, 2), FRAME)
    dense = f.apply(img, exact_2x2=False, filter_mode="bilinear")
    exact = f.apply(img, filter_mode="bilinear")
    np.testing.assert_allclose(dense[:, 4:-4, 4:-4].numpy(), exact[:, 4:-4, 4:-4].numpy(), atol=1e-4)


# ------------------------------------------------------------ Quad


def _sims(*v):
    """One similarity in both packages."""
    f = [np.float32(x) for x in v]
    return jh.Homography.from_similarity(*f), th.Homography.from_similarity(*map(torch.tensor, f))


def test_quad_matches_jax():
    """Quad (reference BoundingQuad): vertices, homography transform and
    every enclosure test equal to the JAX package's (the cases of
    tests/test_warp_field.py::test_quad_encloses)."""
    shrink_j, shrink_t = _sims(0.8, 0.0, 1.0, 1.0)
    move_j, move_t = _sims(1.0, 0.0, 3.0, 2.0)
    pts = np.array([[5.0, 5.0], [25.0, 5.0], [-1.0, 0.0], [19.5, 9.0]], np.float32)
    rects = (((0.0, 0.0), (20.0, 10.0)), ((2.0, 2.0), (18.0, 8.0)), ((2.0, 2.0), (21.0, 8.0)))
    inner_j = jquad.Quad.from_rect((4.0, 12.0)).transform(move_j)
    inner_t = tquad.Quad.from_rect((4.0, 12.0), device="cpu").transform(move_t)
    answers = []
    for qj, qt in ((jquad.Quad.from_rect((10.0, 20.0)), tquad.Quad.from_rect((10.0, 20.0), device="cpu")),
                   (jquad.Quad.from_rect((10.0, 20.0), shrink_j),
                    tquad.Quad.from_rect((10.0, 20.0), shrink_t))):
        np.testing.assert_allclose(qt.vertices.numpy(), np.asarray(qj.vertices), rtol=RTOL, atol=1e-5)
        got = qt.encloses_points(_t(pts)).tolist()
        assert got == np.asarray(qj.encloses_points(jnp.asarray(pts))).tolist()
        got += [bool(qt.encloses_rect(tl, br)) for tl, br in rects] + [bool(qt.encloses_quad(inner_t))]
        assert got[4:] == [bool(qj.encloses_rect(tl, br)) for tl, br in rects] + [
            bool(qj.encloses_quad(inner_j))]
        answers.append(got)
    assert answers[0] == [True, False, False, True, True, True, False, True]
    assert answers[1][4] is False and answers[1][7] is True  # the shrunk quad


# ------------------------------------------------------------ the mesh solve

SIZE, MESH = (96, 120), (9, 11)  # the JAX package's tests/test_mesh_motion.py
SCALE = np.array([SIZE[0] - 1, SIZE[1] - 1], np.float32).reshape(2, 1, 1)


def _gt_field():
    off = np.zeros((2, *MESH), np.float32)
    yy = np.linspace(0, 1, MESH[0])[:, None]
    xx = np.linspace(0, 1, MESH[1])[None, :]
    off[0] = 0.02 * np.sin(2 * np.pi * xx) * (0.5 + 0.5 * yy)
    off[1] = 0.015 * np.cos(2 * np.pi * yy) - 0.01 * xx
    return off


def _points(rng, n=300):
    return np.stack([rng.uniform(2, SIZE[1] - 3, n), rng.uniform(2, SIZE[0] - 3, n)], -1).astype(np.float32)


def _displace(pts, off):
    """src = dst + the field's backward offset at dst, (x, y)."""
    idx, w4 = jmm._bilinear_weights(jnp.asarray(pts), MESH, SIZE)
    d = np.asarray(jmm._sample(jnp.asarray(off * SCALE), idx, w4))  # (N, 2) (dy, dx)
    return (pts + d[:, ::-1]).astype(np.float32)


def test_bilinear_weights_match_jax():
    pts = _points(np.random.default_rng(4))
    pts[:3] = [[0.0, 0.0], [SIZE[1] - 1.0, SIZE[0] - 1.0], [-5.0, 200.0]]  # corners, outside
    ij, wj = jmm._bilinear_weights(jnp.asarray(pts), MESH, SIZE)
    it, wt = tmm._bilinear_weights(_t(pts), MESH, SIZE)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)


def test_sample_and_scatter_match_jax_and_are_adjoint():
    """_sample (A x) and _scatter (A^T r) within 1e-5 of JAX's, and
    <A x, r> = <x, A^T r> to 1e-5 relative."""
    rng = np.random.default_rng(5)
    pts = _points(rng)
    x = rng.normal(size=(2, *MESH)).astype(np.float32)
    r = rng.normal(size=(len(pts), 2)).astype(np.float32)
    ij, wj = jmm._bilinear_weights(jnp.asarray(pts), MESH, SIZE)
    it, wt = tmm._bilinear_weights(_t(pts), MESH, SIZE)
    ax = tmm._sample(_t(x), it, wt)
    atr = tmm._scatter(_t(r), tmm._operator(it, wt, MESH[0] * MESH[1]))
    np.testing.assert_allclose(ax.numpy(), np.asarray(jmm._sample(jnp.asarray(x), ij, wj)), atol=1e-5)
    np.testing.assert_allclose(atr.numpy(), np.asarray(jmm._scatter(jnp.asarray(r), ij, wj, MESH[0] * MESH[1])),
                               atol=1e-5)
    lhs, rhs = float((ax.double() * _t(r).double()).sum()), float((_t(x).double().reshape(2, -1) * atr.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _estimate_case(name):
    """(src, dst, weights, global offsets, settings kwargs, prev_local, prev
    scale) of one solve: the JAX package's smooth-field, outlier and
    no-feature cases (tests/test_mesh_motion.py) and a warm start from a
    previous local mesh on top of a global fit."""
    rng = np.random.default_rng(6)
    gt = _gt_field()
    pts = _points(rng)
    src = _displace(pts, gt)
    ones = np.ones(len(pts), np.float32)
    glob = np.zeros_like(gt)
    if name == "smooth":
        return src, pts, ones, glob, dict(temporal_weight=0.01, rigidity_weight=0.3), None, 1.0
    if name == "outliers":
        bad = rng.choice(len(pts), 60, replace=False)
        src[bad] += (rng.uniform(8, 20, size=(60, 2)) * rng.choice([-1, 1], (60, 2))).astype(np.float32)
        return src, pts, ones, glob, dict(temporal_weight=0.01, rigidity_weight=0.3, irls_rounds=3), None, 1.0
    if name == "no_features":
        z = np.zeros((10, 2), np.float32)
        return z, z, np.zeros(10, np.float32), gt, {}, None, 1.0
    # warm start: a global fit (a small pan) plus last frame's local mesh,
    # half the features dropped.
    glob[1] += 0.01
    weights = (rng.uniform(size=len(pts)) > 0.5).astype(np.float32)
    return _displace(pts, gt + glob), pts, weights, glob, {}, 0.5 * gt, 1.0


ESTIMATE_CASES = ["smooth", "outliers", "no_features", "warm_start"]


@functools.cache
def _jax_estimate(name):
    src, dst, wts, glob, kw, prev, pscale = _estimate_case(name)
    est = jax.jit(jmm.estimate, static_argnums=(4, 5))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wts), jwf.WarpField(offsets=jnp.asarray(glob)),
        SIZE, jcfg.MeshMotionSettings(**kw),
        None if prev is None else jwf.WarpField(offsets=jnp.asarray(prev)), pscale)
    return tuple(np.asarray(v) for v in (est[0].offsets, est[1], est[2]))


@pytest.mark.parametrize("name", ESTIMATE_CASES)
def test_mesh_estimate_matches_jax(name):
    """The whole solve on the same inputs: offsets within 1e-3 detection px,
    the mean residual within 1e-3 px, and inlier masks equal except where
    JAX's squared residual lies within 1e-3 px^2 of the threshold."""
    src, dst, wts, glob, kw, prev, pscale = _estimate_case(name)
    settings = tcfg.MeshMotionSettings(**kw)
    oj, inl_j, res_j = _jax_estimate(name)
    est, inl_t, res_t = tmm.estimate(
        _t(src), _t(dst), _t(wts), twf.WarpField(offsets=_t(glob)), SIZE, settings,
        None if prev is None else twf.WarpField(offsets=_t(prev)), pscale)
    assert np.abs((est.offsets.numpy() - oj) * SCALE).max() <= 1e-3
    assert abs(float(res_t) - float(res_j)) <= 1e-3
    idx, w4 = jmm._bilinear_weights(jnp.asarray(dst), MESH, SIZE)
    r = np.asarray(jmm._sample(jnp.asarray(oj * SCALE), idx, w4)) - np.stack(
        [src[:, 1] - dst[:, 1], src[:, 0] - dst[:, 0]], -1)
    clear = np.abs((r * r).sum(-1) - settings.inlier_threshold_px ** 2) > 1e-3
    np.testing.assert_array_equal(inl_t.numpy()[clear], inl_j[clear])
    if name in ("smooth", "outliers"):  # the JAX tests' own recovery bounds, on the port
        err = np.abs((est.offsets.numpy() - _gt_field()) * SCALE)[:, 1:-1, 1:-1]
        assert err.max() < (0.5 if name == "smooth" else 1.0)


def test_mesh_estimate_tensor_prev_scale_zero_ignores_prev():
    """prev_weight_scale as a 0-d tensor 0 (the tracker's first frame)
    gives the solve without a previous mesh."""
    src, dst, wts, glob, kw, prev, _ = _estimate_case("warm_start")
    args = (_t(src), _t(dst), _t(wts), twf.WarpField(offsets=_t(glob)), SIZE, tcfg.MeshMotionSettings())
    a = tmm.estimate(*args, twf.WarpField(offsets=_t(prev)), torch.tensor(0.0))[0].offsets
    b = tmm.estimate(*args)[0].offsets
    torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


# ------------------------------------------------------------ the stabilizer

CLIP, N, CARRY_AT, PREDICTIVE, STAB_MESH = (96, 128), 16, 8, 2, (9, 11)


def _settings(cfg):
    """The flagship settings cut to size in mesh mode: 48x64 detection, a
    9x11 mesh, a 6x8 grid, 32 hypotheses, a 2-frame window."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(48, 64),
            motion_resolution=STAB_MESH,
            detector=cfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=6,
            motion=cfg.MotionEstimationSettings(hypotheses=32),
        ),
        smoother=cfg.PathSmootherSettings(predictive_samples=PREDICTIVE),
    )


def _yuv(luma):
    y = np.asarray(luma, np.float32)
    return np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)])


def _leaf_to_numpy(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    """One JAX run (one jit of step) and one port run of the mesh
    stabilizer over the same shaky clip, then a stall tick and drain
    bubbles; the JAX state after CARRY_AT frames."""
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(220, 260, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    clip = [_yuv(fixtures.render_frame(base, p, CLIP)) for p in poses]
    ticks = [(px, True, False) for px in clip] + [(clip[-1], False, False)] + [(clip[-1], False, True)] * 2
    fj = lj.StabilizationFilter(settings=_settings(jcfg))
    ft = lt.StabilizationFilter(settings=_settings(tcfg))
    sj = fj.init(lj.FrameSpec(*CLIP, 3, lj.PixelFormat.YUV))
    st = ft.init(lt.FrameSpec(*CLIP, 3, lt.PixelFormat.YUV), device="cpu")
    step = jax.jit(fj.step)
    jout, tout, carried = [], [], None
    for t, (px, valid, drain) in enumerate(ticks):
        if t == CARRY_AT:
            carried = jax.tree.map(_leaf_to_numpy, sj)
        sj, oj = step(sj, lj.Frame.create(jnp.asarray(px), timestamp=t / 30.0, fmt=lj.PixelFormat.YUV,
                                          valid=valid), drain=jnp.asarray(drain))
        st, ot = ft.step(st, lt.Frame.create(torch.from_numpy(px), timestamp=t / 30.0,
                                             fmt=lt.PixelFormat.YUV, valid=valid), drain=drain)
        jout.append(dict(valid=bool(oj.valid), px=np.asarray(oj.pixels), corr=np.asarray(sj.correction.offsets),
                         has_mesh=bool(sj.tracker.has_prev_mesh)))
        tout.append(dict(valid=bool(ot.valid), px=ot.pixels.numpy(), corr=st.correction.offsets.numpy(),
                         has_mesh=bool(st.tracker.has_prev_mesh)))
    return dict(poses=poses, jax=jout, torch=tout, carried=carried, clip=clip, filt=ft)


def test_mesh_valid_flags_equal(runs):
    """Valid flags frame for frame, stall and drain tail included; the
    tracker holds a previous mesh from the second frame on."""
    assert [o["valid"] for o in runs["torch"]] == [o["valid"] for o in runs["jax"]]
    assert [o["has_mesh"] for o in runs["torch"][1:N]] == [True] * (N - 1)


def test_mesh_corrections_agree(runs):
    """Per frame, the (2, 9, 11) correction within 2e-3 normalised units of
    JAX's (the bound of tests/test_torch_stabilization.py: the packages draw
    different RANSAC samples for the global fit the mesh is anchored on)."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        assert ot["corr"].shape == (2, *STAB_MESH)
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3


def _field_at(c, xt):
    """A (2, gh, gw) normalized field's (dx, dy) pixel offset at the (x, y)
    point, bilinear in the grid (as tools/oracle_pipeline.py reads it)."""
    h, w = CLIP
    gh, gw = c.shape[1:]
    fy = np.clip(xt[1] / (h - 1) * (gh - 1), 0, gh - 1)
    fx = np.clip(xt[0] / (w - 1) * (gw - 1), 0, gw - 1)
    y0, x0 = min(int(fy), gh - 2), min(int(fx), gw - 2)
    wy, wx = fy - y0, fx - x0
    v = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x0 + 1] * (1 - wy) * wx
         + c[:, y0 + 1, x0] * wy * (1 - wx) + c[:, y0 + 1, x0 + 1] * wy * wx)
    return np.array([v[1] * (w - 1), v[0] * (h - 1)])


def _output_track(runs, key):
    s = np.array([[130.0, 110.0]], np.float32)
    x_in, y_out = [], []
    for t in range(N):
        o = runs[key][t]
        if not o["valid"]:
            continue
        xt = np.asarray(runs["poses"][t - PREDICTIVE].inverse().transform(jnp.asarray(s)))[0]
        x_in.append(xt)
        y_out.append(xt - _field_at(o["corr"], xt))
    return np.array(x_in), np.array(y_out)


@pytest.mark.parametrize("metric", ["jitter", "ate"])
def test_mesh_trajectory_quality_matches_jax(runs, metric):
    """Jitter and ATE of the output trajectory (the field read bilinearly at
    a scene point) within 0.8-1.25x of the JAX run's (1.25: the
    ORACLE_TRAJECTORY_MESH.json bound), and the JAX output smoother than
    the input."""
    x_in, yj = _output_track(runs, "jax")
    _, yt = _output_track(runs, "torch")
    if metric == "jitter":
        mj, mt = metrics.jitter(yj), metrics.jitter(yt)
        assert mj < metrics.jitter(x_in)
    else:
        ideal = metrics.smooth_path(x_in, sigma=4.0)
        mj, mt = metrics.ate(yj, ideal), metrics.ate(yt, ideal)
    assert 0.8 <= mt / mj <= 1.25, (mt, mj)


def test_mesh_pixels_match_jax(runs):
    """Valid output frames within 1 LSB of JAX's on >= 99% of pixels (the
    warps differ by the corrections' 2e-3 at most)."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        if oj["valid"]:
            d = np.abs(np.round(ot["px"] * 255.0) - np.round(oj["px"] * 255.0))
            assert (d <= 1).mean() >= 0.99, (d <= 1).mean()


def test_mesh_state_carried_from_jax(runs):
    """The JAX mesh state after CARRY_AT frames (its previous local mesh
    included), carried by interop and stepped once by the port: the next
    correction within 1e-3 normalised units of JAX's."""
    ft = runs["filt"]
    state = interop.stabilizer_state_from_numpy(runs["carried"], ft.settings, "cpu")
    assert state.tracker.prev_mesh.shape == (2, *STAB_MESH) and bool(state.tracker.has_prev_mesh)
    np.testing.assert_array_equal(state.tracker.prev_mesh.numpy(), runs["carried"].tracker.prev_mesh)
    state, out = ft.step(state, lt.Frame.create(torch.from_numpy(runs["clip"][CARRY_AT]),
                                                timestamp=CARRY_AT / 30.0, fmt=lt.PixelFormat.YUV))
    ref = runs["jax"][CARRY_AT]
    assert bool(out.valid) == ref["valid"]
    assert np.abs(state.correction.offsets.numpy() - ref["corr"]).max() <= 1e-3
    with pytest.raises(ValueError, match="motion_resolution"):
        interop.stabilizer_state_from_numpy(runs["carried"], tcfg.StabilizationFilterSettings(), "cpu")
