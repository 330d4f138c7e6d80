"""Port parity of the scaling slice on the CPU: the plain EASU scale and
RCAS, the ScalingFilter, and the stabilizer -> 2x scaler chain against the
JAX package (its XLA paths), with a JAX chain state carried into the port
mid-stream."""

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
from livevisionkit_tpu.ops import easu as jeasu
from livevisionkit_tpu.ops import rcas as jrcas
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch.ops import easu as teasu
from livevisionkit_tpu_torch.ops import rcas as trcas

# name -> (input shape, output size, pixel format, rational form?)
EASU_CASES = {
    "2x_yuv": ((3, 32, 48), (64, 96), "YUV", True),
    "2x_rgb": ((3, 32, 48), (64, 96), "RGB", True),
    "3/2": ((3, 32, 48), (48, 72), "YUV", True),
    "4/3": ((3, 36, 48), (48, 64), "YUV", True),
    # 3x by 2x: 99 rows are not a multiple of the 6 row phases.
    "3x2_odd": ((3, 33, 47), (99, 94), "YUV", True),
    "fallback": ((3, 30, 45), (63, 95), "YUV", False),
    "downscale": ((3, 48, 64), (30, 40), "RGB", False),
    "gray_2d": ((32, 48), (64, 96), "GRAY", True),
}
SIZE, OUT = (96, 128), (192, 256)  # the chain's stabilizer and scaler sizes
N, CARRY_AT, PREDICTIVE = 12, 6, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape, seed=0):
    """Uniform noise in [0.2, 0.8] with a bright block and a dark bar, so
    the edge-adaptive path sees hard edges."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.2, 0.8, size=shape).astype(np.float32)
    h, w = shape[-2:]
    img[..., h // 4: h // 2, w // 3: 2 * w // 3] = 0.95
    img[..., 2 * h // 3: 2 * h // 3 + 3, w // 8: w // 2] = 0.05
    return img


@functools.cache
def _jax_easu(name):
    """JAX easu_scale(force="xla") of one case, computed once (eager JAX
    takes seconds a call here)."""
    shape, size, fmt, _ = EASU_CASES[name]
    img = _image(shape)
    out = jeasu.easu_scale(jnp.asarray(img), size, fmt=getattr(lj.PixelFormat, fmt), force="xla")
    return img, np.asarray(out)


@pytest.mark.parametrize("name", list(EASU_CASES))
def test_easu_scale_matches_jax(name):
    """Plain easu_scale against JAX's XLA path, atol 1e-5, in both the
    rational and the fallback form."""
    shape, size, fmt, rational = EASU_CASES[name]
    assert teasu.scale_plan(shape[-2:], size).rational == rational
    img, want = _jax_easu(name)
    got = teasu.easu_scale(torch.from_numpy(img), size, getattr(lt.PixelFormat, fmt))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_easu_scale_rgb_luma_differs_from_yuv():
    """`fmt` picks the luma: RGB's 0.5*ch0 + ch1 + 0.5*ch2 steers the
    kernel shape differently from plane 0, and matches JAX's RGB result."""
    img, want_rgb = _jax_easu("2x_rgb")
    _, want_yuv = _jax_easu("2x_yuv")
    x = torch.from_numpy(img)
    rgb = teasu.easu_scale(x, (64, 96), lt.PixelFormat.RGB).numpy()
    yuv = teasu.easu_scale(x, (64, 96), lt.PixelFormat.YUV).numpy()
    assert np.abs(rgb - yuv).max() > 1e-3
    np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(yuv, want_yuv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 40, 56), (40, 56)])
@pytest.mark.parametrize("sharpness", [0.5, 1.0])
def test_rcas_matches_jax(shape, sharpness):
    """Plain rcas against JAX's XLA form, atol 1e-6, for (C,H,W) and (H,W);
    the border is copied through."""
    img = _image(shape, seed=1)
    want = np.asarray(jrcas.rcas(jnp.asarray(img), sharpness, force="xla"))
    got = trcas.rcas(torch.from_numpy(img), sharpness).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 0, :], img[..., 0, :])
    np.testing.assert_array_equal(got[..., :, -1], img[..., :, -1])
    assert np.abs(got - img).max() > 1e-3


# name -> (output_size, sharpness)
SCALER_SETTINGS = {"rcas_only": (None, 0.8), "upscale_only": ((64, 96), 0.0), "both": ((64, 96), 0.8)}


@pytest.mark.parametrize("name", list(SCALER_SETTINGS))
def test_scaling_filter_matches_jax(name):
    """ScalingFilter.step of both packages on one YUV frame, atol 1e-5, and
    the output spec."""
    size, sharp = SCALER_SETTINGS[name]
    img = _image((3, 32, 48), seed=2)
    fj = lj.ScalingFilter(jcfg.ScalingFilterSettings(output_size=size, sharpness=sharp))
    ft = lt.ScalingFilter(tcfg.ScalingFilterSettings(output_size=size, sharpness=sharp))
    _, oj = fj.step((), lj.Frame.create(jnp.asarray(img), timestamp=0.5, fmt=lj.PixelFormat.YUV))
    _, ot = ft.step((), lt.Frame.create(torch.from_numpy(img), timestamp=0.5, fmt=lt.PixelFormat.YUV))
    np.testing.assert_allclose(ot.pixels.numpy(), np.asarray(oj.pixels), rtol=0, atol=1e-5)
    assert ot.format == lt.PixelFormat.YUV and float(ot.timestamp) == 0.5 and bool(ot.valid)
    sj = fj.output_spec(lj.FrameSpec(32, 48, 3, lj.PixelFormat.YUV))
    st = ft.output_spec(lt.FrameSpec(32, 48, 3, lt.PixelFormat.YUV))
    assert (st.height, st.width) == (sj.height, sj.width) == tuple(ot.pixels.shape[-2:])


def test_composite_filter_protocol():
    """CompositeFilter: summed delay, joined name, the walked output spec,
    one state per stage, and an IdentityFilter stage that passes through."""
    stab = lt.StabilizationFilter(settings=_stab_settings(tcfg))
    chain = lt.CompositeFilter((lt.IdentityFilter(), stab, lt.ScalingFilter(
        tcfg.ScalingFilterSettings(output_size=OUT))))
    jchain = lj.CompositeFilter((lj.IdentityFilter(), lj.StabilizationFilter(settings=_stab_settings(jcfg)),
                                 lj.ScalingFilter(jcfg.ScalingFilterSettings(output_size=OUT))))
    assert chain.delay == jchain.delay == PREDICTIVE
    assert chain.name == jchain.name == "IdentityFilter+StabilizationFilter+ScalingFilter"
    spec = chain.output_spec(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV))
    assert (spec.height, spec.width, spec.channels) == (*OUT, 3)
    state = chain.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    assert len(state) == 3 and state[0] == () and state[2] == ()
    assert state[1].frames.data["pixels"].shape[1:] == (3, *SIZE)
    frame = lt.Frame.create(torch.rand(3, *SIZE), fmt=lt.PixelFormat.YUV)
    _, out = lt.IdentityFilter().step((), frame)
    assert out is frame


def _stab_settings(cfg):
    """The flagship settings cut to size, as in tests/test_torch_stabilization.py."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(48, 64),
            detector=cfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=6,
            motion=cfg.MotionEstimationSettings(hypotheses=32),
        ),
        smoother=cfg.PathSmootherSettings(predictive_samples=PREDICTIVE),
    )


def _chain(pkg, cfg):
    return pkg.CompositeFilter((
        pkg.StabilizationFilter(settings=_stab_settings(cfg)),
        pkg.ScalingFilter(cfg.ScalingFilterSettings(output_size=OUT, sharpness=0.8)),
    ))


def _leaf_to_numpy(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


@pytest.fixture(scope="module")
def chain_runs():
    """The chain of both packages over the same shaky YUV clip (one jit of
    the JAX step), the JAX state after CARRY_AT frames, and the port's next
    output from that state."""
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(220, 260, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    clip = []
    for p in poses:
        y = np.asarray(fixtures.render_frame(base, p, SIZE), np.float32)
        clip.append(np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)]))

    cj, ct = _chain(lj, jcfg), _chain(lt, tcfg)
    sj = cj.init(lj.FrameSpec(*SIZE, 3, lj.PixelFormat.YUV))
    st = ct.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    step = jax.jit(cj.step)
    jout, tout, carried = [], [], None
    for t, px in enumerate(clip):
        if t == CARRY_AT:
            carried = jax.tree.map(_leaf_to_numpy, sj)
        sj, oj = step(sj, lj.Frame.create(jnp.asarray(px), timestamp=t / 30.0, fmt=lj.PixelFormat.YUV))
        st, ot = ct.step(st, lt.Frame.create(torch.from_numpy(px), timestamp=t / 30.0,
                                             fmt=lt.PixelFormat.YUV))
        jout.append((bool(oj.valid), np.asarray(oj.pixels)))
        tout.append((bool(ot.valid), ot.pixels.numpy()))

    state = interop.composite_state_from_numpy(carried, ct.filters, "cpu")
    _, out = ct.step(state, lt.Frame.create(torch.from_numpy(clip[CARRY_AT]), timestamp=CARRY_AT / 30.0,
                                            fmt=lt.PixelFormat.YUV))
    return dict(jax=jout, torch=tout, carried=(bool(out.valid), out.pixels.numpy()))


def _assert_close_pixels(got, want):
    """Max 4/255, mean 1e-4: the stabilizer's u8 queue allows 1 LSB, and
    RCAS at sharpness 0.8 amplifies a difference by up to
    (1 + 4 * 0.15) / (1 - 0.6) = 4."""
    d = np.abs(got - want)
    assert d.max() <= 4.0 / 255.0 and d.mean() <= 1e-4, (d.max(), d.mean())


def test_chain_valid_flags_equal(chain_runs):
    """Valid flags frame for frame: the stabilizer's warm-up passes through
    the scaler."""
    vj = [v for v, _ in chain_runs["jax"]]
    vt = [v for v, _ in chain_runs["torch"]]
    assert vt == vj == [t >= PREDICTIVE for t in range(N)]


def test_chain_pixels_match_jax(chain_runs):
    """Every valid output frame is (3, 192, 256) and within the bounds of
    `_assert_close_pixels` of JAX's."""
    for (vj, pj), (vt, pt) in zip(chain_runs["jax"], chain_runs["torch"]):
        assert pt.shape == pj.shape == (3, *OUT)
        if vj and vt:
            _assert_close_pixels(pt, pj)


def test_chain_state_carried_from_jax(chain_runs):
    """One port step from the JAX chain's state after CARRY_AT frames gives
    JAX's next output, within the chain's bounds."""
    valid, px = chain_runs["carried"]
    vj, pj = chain_runs["jax"][CARRY_AT]
    assert valid == vj
    _assert_close_pixels(px, pj)
