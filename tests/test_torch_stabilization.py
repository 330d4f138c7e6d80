"""Port parity of the whole slice: the StabilizationFilter of both packages
on a fixture shaky clip (3-channel YUV), and a JAX state carried into the
port mid-stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch.utils import metrics

SIZE = (96, 128)
N = 16
CARRY_AT = 8  # the JAX state after this many frames is carried into the port
PREDICTIVE = 2
STALL, DRAIN = 2, 3  # tail: a stall tick, then drain bubbles


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(cfg):
    """The flagship settings cut to size, built from either package's config
    module: 48x64 detection, a 6x8 grid, 32 hypotheses, a 2-frame window."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(48, 64),
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
    """One JAX run (one jit of step) and one port run over the same clip:
    N frames, then a stall tick and drain bubbles."""
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(220, 260, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    clip = [_yuv(fixtures.render_frame(base, p, SIZE)) for p in poses]
    ticks = [(px, True, False) for px in clip]
    ticks += [(clip[-1], False, False)] * STALL + [(clip[-1], False, True)] * DRAIN

    fj = lj.StabilizationFilter(settings=_settings(jcfg))
    ft = lt.StabilizationFilter(settings=_settings(tcfg))
    sj = fj.init(lj.FrameSpec(*SIZE, 3, lj.PixelFormat.YUV))
    st = ft.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    step = jax.jit(fj.step)
    jout, tout, carried = [], [], None
    for t, (px, valid, drain) in enumerate(ticks):
        if t == CARRY_AT:
            carried = jax.tree.map(_leaf_to_numpy, sj)
        sj, oj = step(sj, lj.Frame.create(jnp.asarray(px), timestamp=t / 30.0, fmt=lj.PixelFormat.YUV,
                                          valid=valid), drain=jnp.asarray(drain))
        st, ot = ft.step(st, lt.Frame.create(torch.from_numpy(px), timestamp=t / 30.0,
                                             fmt=lt.PixelFormat.YUV, valid=valid), drain=drain)
        jout.append(dict(valid=bool(oj.valid), ts=float(oj.timestamp), px=np.asarray(oj.pixels),
                         corr=np.asarray(sj.correction.offsets), trust=float(sj.trust),
                         scene=float(sj.scene_quality)))
        tout.append(dict(valid=bool(ot.valid), ts=float(ot.timestamp), px=ot.pixels.numpy(),
                         corr=st.correction.offsets.numpy()))
    return dict(poses=poses, jax=jout, torch=tout, carried=carried, clip=clip, filt=ft)


def test_valid_flags_equal(runs):
    """(g) Output valid flags frame for frame, stall and drain tail included."""
    vj = [o["valid"] for o in runs["jax"]]
    vt = [o["valid"] for o in runs["torch"]]
    assert vt == vj
    assert vt[:PREDICTIVE] == [False] * PREDICTIVE and vt[N - 1]
    tail_ts = [o["ts"] for o in runs["torch"] if o["valid"]]
    assert tail_ts == [o["ts"] for o in runs["jax"] if o["valid"]]


def test_corrections_agree(runs):
    """(g) Per-frame correction offsets within 2e-3 normalised units (the
    two packages draw different RANSAC samples)."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3


def _output_track(runs, key):
    """A scene point's output path: input x_t = P_t^-1(s) of the delayed
    frame, moved by the applied correction, read at its nearest node."""
    pred = PREDICTIVE
    h, w = SIZE
    s = np.array([[130.0, 110.0]], np.float32)
    x_in, y_out = [], []
    for t in range(N):
        o = runs[key][t]
        if not o["valid"]:
            continue
        xt = np.asarray(runs["poses"][t - pred].inverse().transform(jnp.asarray(s)))[0]
        c = o["corr"]
        gy = int(np.clip(round(xt[1] / (h - 1)), 0, 1))
        gx = int(np.clip(round(xt[0] / (w - 1)), 0, 1))
        x_in.append(xt)
        y_out.append(xt - np.array([c[1, gy, gx] * (w - 1), c[0, gy, gx] * (h - 1)]))
    return np.array(x_in), np.array(y_out)


@pytest.mark.parametrize("metric", ["jitter", "ate"])
def test_trajectory_quality_matches_jax(runs, metric):
    """(g) Jitter and ATE of the port's output trajectory within 0.8-1.25x
    of the JAX run's (1.25: the ORACLE_TRAJECTORY.json bound)."""
    x_in, yj = _output_track(runs, "jax")
    _, yt = _output_track(runs, "torch")
    if metric == "jitter":
        mj, mt = metrics.jitter(yj), metrics.jitter(yt)
        assert mj < metrics.jitter(x_in)
    else:
        ideal = metrics.smooth_path(x_in, sigma=4.0)
        mj, mt = metrics.ate(yj, ideal), metrics.ate(yt, ideal)
    assert 0.8 <= mt / mj <= 1.25, (mt, mj)


@pytest.fixture(scope="module")
def carried_step(runs):
    """The JAX state after CARRY_AT frames, converted, stepped on the next
    frame by the port (with its own RANSAC draw)."""
    ft = runs["filt"]
    state = interop.stabilizer_state_from_numpy(runs["carried"], ft.settings, "cpu")
    px = runs["clip"][CARRY_AT]
    state, out = ft.step(state, lt.Frame.create(torch.from_numpy(px), timestamp=CARRY_AT / 30.0,
                                                fmt=lt.PixelFormat.YUV))
    return state, out, runs["jax"][CARRY_AT]


@pytest.mark.parametrize("what", ["correction", "pixels", "trust", "scene_quality"])
def test_state_carried_from_jax(carried_step, what):
    """(h) One step from a carried JAX state: corrections within 1e-3
    normalised units, output pixels within 1 LSB on >= 99.5% of pixels,
    trust and scene quality within 1e-5."""
    state, out, ref = carried_step
    assert bool(out.valid) == ref["valid"]
    if what == "correction":
        assert np.abs(state.correction.offsets.numpy() - ref["corr"]).max() <= 1e-3
    elif what == "pixels":
        d = np.abs(np.round(out.pixels.numpy() * 255.0) - np.round(ref["px"] * 255.0))
        assert (d <= 1).mean() >= 0.995
    elif what == "trust":
        assert abs(float(state.trust) - ref["trust"]) <= 1e-5
    else:
        assert abs(float(state.scene_quality) - ref["scene"]) <= 1e-5


def test_bypass_only_delays(runs):
    """enabled=False keeps the delay queue and nothing else: the output at
    step t is input t - PREDICTIVE, through the u8 queue."""
    filt = lt.StabilizationFilter(settings=_settings(tcfg), enabled=False)
    state = filt.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    clip = runs["clip"][:6]
    for t, px in enumerate(clip):
        state, out = filt.step(state, lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.YUV))
        assert bool(out.valid) == (t >= PREDICTIVE)
        if t >= PREDICTIVE:
            want = np.floor(np.clip(clip[t - PREDICTIVE] * 255.0 + 0.5, 0, 255)) / 255.0
            np.testing.assert_allclose(out.pixels.numpy(), want, atol=1e-6)
    assert float(state.trust) == 0.0


def test_crop_field_matches_jax():
    """crop_output's zoom field and its composition with a correction agree
    with the JAX filter's (rtol 1e-4)."""
    fj = lj.StabilizationFilter(settings=_settings(jcfg))
    ft = lt.StabilizationFilter(settings=_settings(tcfg))
    zj = fj._crop_field((2, 2), SIZE)
    zt = ft._crop_field((2, 2), SIZE, "cpu")
    np.testing.assert_allclose(zt.offsets.numpy(), np.asarray(zj.offsets), rtol=1e-4, atol=1e-7)
    c = np.random.default_rng(8).uniform(-0.03, 0.03, size=(2, 2, 2)).astype(np.float32)
    cj = lj.WarpField(offsets=jnp.asarray(c)).compose(zj)
    ct = lt.WarpField(offsets=torch.from_numpy(c)).compose(zt)
    np.testing.assert_allclose(ct.offsets.numpy(), np.asarray(cj.offsets), rtol=1e-4, atol=1e-7)
