"""Port parity of alpha planes on the CPU: the Frame's optional (H, W)
alpha, its resample by `with_pixels`, conversions that leave it alone, the
ScalingFilter carrying it, and the stabilizer's u8 queue and 4-plane warp
against the JAX package (with a JAX state whose queue holds alpha carried
into the port); and the port alone against tests/test_alpha.py:104-132."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.ops import remap as jremap
from livevisionkit_tpu.ops import resample as jres
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch import presets
from livevisionkit_tpu_torch.filters.base import where_state
from livevisionkit_tpu_torch.ops import remap as tremap
from livevisionkit_tpu_torch.parallel import streams

SIZE = (96, 128)
N, CARRY_AT, PREDICTIVE = 12, 6, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alpha(rng, h, w):
    return rng.uniform(size=(h, w)).astype(np.float32)


def test_frame_alpha_and_spec():
    """Frame.create takes an alpha plane (as float32) or none;
    FrameSpec.of reads it; a frame without one flattens, vmaps and gates
    with `where_state` like any frame."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, size=(6, 8)).astype(np.uint8))
    f = lt.Frame.create(torch.rand(3, 6, 8), fmt=lt.PixelFormat.RGB, alpha=a)
    assert f.alpha.dtype == torch.float32 and f.alpha.shape == (6, 8)
    assert lt.FrameSpec.of(f) == lt.FrameSpec(6, 8, 3, lt.PixelFormat.RGB, has_alpha=True)
    g = lt.Frame.create(torch.rand(3, 6, 8), fmt=lt.PixelFormat.YUV)
    assert g.alpha is None and not lt.FrameSpec.of(g).has_alpha
    for frame in (f, g):
        stack = lt.Frame(pixels=frame.pixels.expand(2, -1, -1, -1), timestamp=torch.zeros(2),
                         valid=torch.ones(2, dtype=torch.bool),
                         alpha=None if frame.alpha is None else frame.alpha.expand(2, -1, -1),
                         format=frame.format)
        out = streams.batched(lambda fr: fr.with_pixels(fr.pixels * 0.5))(stack)
        assert (out.alpha is None) == (frame.alpha is None) and out.format is frame.format
        picked = where_state(torch.tensor(False), frame.with_pixels(frame.pixels * 0.0), frame)
        assert torch.equal(picked.pixels, frame.pixels)


@pytest.mark.parametrize("size", [(40, 60), (13, 17)])
def test_with_pixels_resamples_alpha(size):
    """A change of size resamples alpha bilinearly without antialiasing,
    within 1e-6 of JAX's with_pixels, up and down; the same size keeps it."""
    rng = np.random.default_rng(1)
    px, a = rng.uniform(size=(3, 20, 30)).astype(np.float32), _alpha(rng, 20, 30)
    new = rng.uniform(size=(3, *size)).astype(np.float32)
    fj = lj.Frame.create(jnp.asarray(px), fmt=lj.PixelFormat.YUV, alpha=jnp.asarray(a))
    ft = lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.YUV, alpha=torch.from_numpy(a))
    want = np.asarray(fj.with_pixels(jnp.asarray(new)).alpha)
    got = ft.with_pixels(torch.from_numpy(new)).alpha.numpy()
    assert got.shape == size
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ft.with_pixels(torch.from_numpy(px * 0.5)).alpha is ft.alpha


def test_reformat_and_conversion_preserve_alpha():
    """(tests/test_alpha.py:75-80) reformat and ConversionFilter, with and
    without extract_channel, leave alpha as it is."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_alpha(rng, 20, 28))
    f = lt.Frame.create(torch.rand(3, 20, 28), fmt=lt.PixelFormat.RGB, alpha=a)
    assert f.reformat(lt.PixelFormat.YUV).alpha is a
    for extract in (None, 0):
        _, out = lt.ConversionFilter(target=lt.PixelFormat.YUV, extract_channel=extract).step((), f)
        assert out.alpha is a


def test_scaling_filter_carries_alpha():
    """(tests/test_alpha.py:83-100) ScalingFilter 2x: alpha follows the
    output size, within 1e-6 of JAX's resize of it; an opaque plane stays
    1 within 1e-6."""
    rng = np.random.default_rng(3)
    px, a = rng.uniform(size=(3, 16, 24)).astype(np.float32), _alpha(rng, 16, 24)
    filt = lt.ScalingFilter(tcfg.ScalingFilterSettings(output_size=(32, 48)))
    f = lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.RGB, alpha=torch.from_numpy(a))
    _, out = filt.step(filt.init(lt.FrameSpec.of(f), device="cpu"), f)
    assert out.pixels.shape == (3, 32, 48) and out.alpha.shape == (32, 48)
    want = np.asarray(jres.resize(jnp.asarray(a), (32, 48), antialias=False))
    np.testing.assert_allclose(out.alpha.numpy(), want, atol=1e-6, rtol=0)
    _, opaque = filt.step((), f.replace(alpha=torch.ones(16, 24)))
    np.testing.assert_allclose(opaque.alpha.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["YUV", "RGB"])
def test_four_plane_warp_luma_from_colour(fmt):
    """The stabilizer's gather of colour + alpha: EASU's luma comes from
    plane 0 (YUV) or planes 0-2 (RGB), never from alpha, so each colour
    plane equals the 3-plane warp's and the 4-plane warp equals JAX's
    within 1e-4 (f32) and 1 LSB on at most 0.1% of pixels (u8)."""
    rng = np.random.default_rng(4)
    src = np.stack([np.array(fixtures.make_texture(64, 80, rng)) for _ in range(4)]).astype(np.float32)
    smap = np.asarray(lj.Homography.from_similarity(*map(jnp.float32, (1.01, 0.02, 3.5, -2.0)))
                      .sample_map((64, 80)), np.float32)
    pj, pt = getattr(lj.PixelFormat, fmt), getattr(lt.PixelFormat, fmt)
    for dtype in ("float32", "uint8"):
        x = src if dtype == "float32" else np.clip(src * 255.0 + 0.5, 0, 255).astype(np.uint8)
        got = tremap.remap(torch.from_numpy(x), torch.from_numpy(smap), fill=0.0, filter_mode="easu", fmt=pt)
        colour = tremap.remap(torch.from_numpy(x[:3].copy()), torch.from_numpy(smap), fill=0.0,
                              filter_mode="easu", fmt=pt)
        assert torch.equal(got[:3], colour)
        want = np.asarray(jremap.remap(jnp.asarray(x), jnp.asarray(smap), fill=0.0, filter_mode="easu", fmt=pj))
        if dtype == "uint8":
            d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _settings(cfg):
    """The flagship settings cut to size, as tests/test_torch_stabilization.py
    cuts them."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(48, 64),
            detector=cfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=6,
            motion=cfg.MotionEstimationSettings(hypotheses=32),
        ),
        smoother=cfg.PathSmootherSettings(predictive_samples=PREDICTIVE),
    )


def _leaf_to_numpy(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    """The stabilizer of both packages over a shaky YUV clip with an alpha
    plane (a second texture on the same camera path; one jit of the JAX
    step), the JAX state after CARRY_AT frames, and the port's next output
    from it."""
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(220, 260, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    matte = fixtures.make_texture(220, 260, np.random.default_rng(1))
    clip = []
    for p in poses:
        y = np.array(fixtures.render_frame(base, p, SIZE), np.float32)
        a = np.array(fixtures.render_frame(matte, p, SIZE), np.float32)
        clip.append((np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)]), a))
    fj = lj.StabilizationFilter(settings=_settings(jcfg))
    ft = lt.StabilizationFilter(settings=_settings(tcfg))
    sj = fj.init(lj.FrameSpec(*SIZE, 3, lj.PixelFormat.YUV, has_alpha=True))
    st = ft.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV, has_alpha=True), device="cpu")
    assert st.frames.data["alpha"].dtype == torch.uint8
    step = jax.jit(fj.step)
    jout, tout, carried = [], [], None

    def frame_t(t):
        px, a = clip[t]
        return lt.Frame.create(torch.from_numpy(px), timestamp=t / 30.0, fmt=lt.PixelFormat.YUV,
                               alpha=torch.from_numpy(a))

    for t, (px, a) in enumerate(clip):
        if t == CARRY_AT:
            carried = jax.tree.map(_leaf_to_numpy, sj)
        sj, oj = step(sj, lj.Frame.create(jnp.asarray(px), timestamp=t / 30.0, fmt=lj.PixelFormat.YUV,
                                          alpha=jnp.asarray(a)))
        st, ot = ft.step(st, frame_t(t))
        jout.append(dict(valid=bool(oj.valid), px=np.asarray(oj.pixels), alpha=np.asarray(oj.alpha),
                         corr=np.asarray(sj.correction.offsets)))
        tout.append(dict(valid=bool(ot.valid), px=ot.pixels.numpy(), alpha=ot.alpha.numpy(),
                         corr=st.correction.offsets.numpy()))
    state = interop.stabilizer_state_from_numpy(carried, ft.settings, "cpu")
    assert state.frames.data["alpha"].dtype == torch.uint8
    _, out = ft.step(state, frame_t(CARRY_AT))
    return dict(jax=jout, torch=tout, carried=dict(valid=bool(out.valid), px=out.pixels.numpy(),
                                                   alpha=out.alpha.numpy()))


def _assert_close(got, want):
    """Max 4/255, mean 1e-4: the chain bound of tests/test_torch_scaling.py
    (1 LSB of the u8 queue and its warp, with room for the correction's
    small difference)."""
    d = np.abs(got - want)
    assert d.max() <= 4.0 / 255.0 and d.mean() <= 1e-4, (d.max(), d.mean())


def test_stabilizer_alpha_matches_jax(runs):
    """Valid flags, corrections within 2e-3 (tests/test_torch_stabilization.py),
    and each valid frame's colour planes and alpha within the chain bound
    of JAX's: alpha rides the u8 queue and the 4-plane warp."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        assert ot["valid"] == oj["valid"]
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3
        assert ot["alpha"].shape == SIZE
        if oj["valid"]:
            _assert_close(ot["px"], oj["px"])
            _assert_close(ot["alpha"], oj["alpha"])
    assert sum(o["valid"] for o in runs["torch"]) == N - PREDICTIVE


def test_stabilizer_alpha_state_carried_from_jax(runs):
    """One port step from a JAX state whose delay queue holds u8 alpha
    planes gives JAX's next frame and alpha within the chain bound."""
    ref, got = runs["jax"][CARRY_AT], runs["carried"]
    assert got["valid"] == ref["valid"]
    _assert_close(got["px"], ref["px"])
    _assert_close(got["alpha"], ref["alpha"])


def test_stabilizer_rejects_alpha_mismatch():
    filt = lt.StabilizationFilter(settings=_settings(tcfg))
    state = filt.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        filt.step(state, lt.Frame.create(torch.rand(3, *SIZE), fmt=lt.PixelFormat.YUV,
                                         alpha=torch.rand(*SIZE)))


def test_stabilizer_warps_alpha_with_pixels():
    """(tests/test_alpha.py:104-132) A stream whose luma equals its alpha
    stays so after stabilization, within 1e-5: one gather, one fill."""
    h, w = SIZE
    filt = lt.StabilizationFilter(settings=presets.stabilization_preset(model="homography"))
    tex = np.array(fixtures.make_texture(h, w, np.random.default_rng(42)))
    spec = lt.FrameSpec(h, w, 3, lt.PixelFormat.YUV, has_alpha=True)
    state = filt.init(spec, device="cpu")
    out = None
    for t in range(filt.delay + 3):
        shift = torch.from_numpy(np.roll(tex, t % 3, axis=1).copy())
        fr = lt.Frame.create(torch.stack([shift] * 3), timestamp=t / 30.0, fmt=lt.PixelFormat.YUV,
                             alpha=shift)
        state, out = filt.step(state, fr)
    assert bool(out.valid)
    np.testing.assert_allclose(out.alpha.numpy(), out.pixels[0].numpy(), atol=1e-5)
