"""Port parity of the multi-stream slice.

* The batched warp (the vmap rule of the port's ``lvk::remap``) against the
  JAX package's vmapped XLA warp and against its batched Pallas kernel K2
  in interpret mode, and that the rule is entered once per batch.
* `MultiStreamFilter.step` against ``jax.jit(jax.vmap(step))`` on a tiny
  filter over 3 streams, with a stall tick and drain bubbles, and a batched
  JAX state carried into the port; the same over the stabilizer ->
  `ScalingFilter` chain, over the stabilizer -> deblocker -> CAS chain
  and over the stabilizer in mesh mode.
* The batched EASU scale and RCAS (the vmap rules of ``lvk::easu_scale``
  and ``lvk::rcas``) entered once a tick, and an op with no batching rule
  raising.
* The driver `stream_multi` against a loop of the port's solo step.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.filters.base import CompositeFilter as JComposite
from livevisionkit_tpu.models.homography import Homography as JH
from livevisionkit_tpu.ops import easu as jeasu
from livevisionkit_tpu.ops import remap as jremap
from livevisionkit_tpu.ops.tpu_kernels import warp as pwarp
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch.ops import remap as tremap
from livevisionkit_tpu_torch.parallel import streams
from livevisionkit_tpu_torch.runtime import multistream
from livevisionkit_tpu_torch.utils import metrics

S = 3
SIZE = (64, 96)
N = 12  # live frames per stream in the step test
PREDICTIVE = 2
CARRY_AT = 6  # the JAX state before this tick is carried into the port
YUV_T, YUV_J = lt.PixelFormat.YUV, lj.PixelFormat.YUV


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the warp


def _batched_case(channels, seed=0):
    """Three streams at the shapes of the JAX package's batched-warp tests
    (tests/test_pallas_warp.py::_batched_case): distinct mean shifts and
    rotation/scale residuals, 96x128."""
    rng = np.random.default_rng(seed)
    srcs = np.stack([
        np.stack([np.asarray(fixtures.make_texture(96, 128, rng)) for _ in range(channels)])
        for _ in range(S)
    ])
    sims = [(1.0, 0.0, 21.0, -13.0), (1.01, 0.02, -7.0, 4.0), (0.99, -0.015, 0.0, 30.0)]
    smaps = np.stack([
        np.asarray(JH.from_similarity(*map(jnp.float32, p)).sample_map((96, 128))) for p in sims
    ])
    return srcs.astype(np.float32), smaps.astype(np.float32)


def _u8(x):
    return np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _port_batched(srcs, smaps, **kw):
    return torch.func.vmap(lambda im, sm: tremap.remap(im, sm, **kw))(
        torch.from_numpy(srcs), torch.from_numpy(smaps)).numpy()


@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_batched_warp_matches_jax_vmap(mode, dtype):
    """The port's vmapped remap against jax.vmap of JAX's remap (the XLA
    path on the CPU), fill 0: f32 within 1e-4 (rsqrt, order of sums); u8
    at most 1 LSB apart on at most 0.1% of pixels."""
    srcs, smaps = _batched_case(3 if mode == "easu" else 2)
    if dtype == "uint8":
        srcs = _u8(srcs)
    kw = dict(fill=0.0, filter_mode=mode)
    want = np.asarray(jax.vmap(lambda im, sm: jremap.remap(im, sm, fmt=YUV_J, **kw))(
        jnp.asarray(srcs), jnp.asarray(smaps)))
    got = _port_batched(srcs, smaps, fmt=YUV_T, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "uint8":
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _inside(smaps, lo, hi_off):
    h, w = smaps.shape[-2:]
    return ((smaps[:, 0] >= lo) & (smaps[:, 0] <= h - hi_off)
            & (smaps[:, 1] >= lo) & (smaps[:, 1] <= w - hi_off))[:, None]


def test_batched_warp_matches_k2_bilinear():
    """Against the TPU kernel K2 itself (pallas_remap_batched, interpret
    mode, tile 64, margin 8), unfilled, masked to in-range samples as in
    tests/test_pallas_warp.py:157-182: max 2e-2 (K2's separability bound)."""
    srcs, smaps = _batched_case(2)
    want = np.asarray(pwarp.pallas_remap_batched(
        jnp.asarray(srcs), jnp.asarray(smaps), tile=64, margin=8, interpret=True))
    got = _port_batched(srcs, smaps, fill=None, filter_mode="bilinear")
    err = (np.abs(got - want) * _inside(smaps, 1, 2))[..., 12:-12, 12:-12]
    assert err.max() < 2e-2, err.max()


def test_batched_warp_matches_k2_easu():
    """The EASU K2 against the port's vmapped EASU remap, unfilled, masked
    as in tests/test_pallas_warp.py:334-370: q99.9 < 4e-2, mean < 1e-3
    (K2's floor flips at near-integer positions and its two-pass shear)."""
    srcs, smaps = _batched_case(3)
    want = np.asarray(pwarp.pallas_remap_batched(
        jnp.asarray(srcs), jnp.asarray(smaps), tile=64, margin=8, interpret=True,
        filter_mode="easu", fmt=YUV_J))
    # As a cross-check of the mask, the JAX XLA oracle agrees with the port.
    oracle = np.asarray(jax.vmap(lambda im, sm: jeasu.easu_remap(im, sm, fmt=YUV_J, fill=None))(
        jnp.asarray(srcs), jnp.asarray(smaps)))
    got = _port_batched(srcs, smaps, fill=None, filter_mode="easu", fmt=YUV_T)
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=0)
    err = (np.abs(got - want) * _inside(smaps, 2, 4))[..., 16:-16, 16:-16]
    assert np.quantile(err, 0.999) < 4e-2, np.quantile(err, 0.999)
    assert err.mean() < 1e-3, err.mean()


@pytest.mark.parametrize("shared", ["none", "map"])
def test_batched_warp_dispatch(monkeypatch, shared):
    """vmap over the port's remap enters the vmap rule ONCE with the stacked
    shape (not once per stream), as JAX's custom_vmap rule does
    (tests/test_pallas_warp.py:202-221); an unbatched map reaches it at
    stream stride 0, not copied.  The result equals the solo remaps."""
    srcs, smaps = _batched_case(3)
    calls = []
    orig = tremap.remap_batched_plain

    def spy(imgs, maps, **kw):
        calls.append((tuple(imgs.shape), maps.stride(0)))
        return orig(imgs, maps, **kw)

    monkeypatch.setattr(tremap, "remap_batched_plain", spy)
    imgs = torch.from_numpy(srcs)
    maps = torch.from_numpy(smaps)
    if shared == "map":
        got = streams.batched(lambda im: tremap.remap(im, maps[1], fill=0.25))(imgs)
        solo = [tremap.remap(imgs[s], maps[1], fill=0.25) for s in range(S)]
        assert calls == [(tuple(imgs.shape), 0)]
    else:
        got = streams.batched(lambda im, sm: tremap.remap(im, sm, fill=0.25))(imgs, maps)
        solo = [tremap.remap(imgs[s], maps[s], fill=0.25) for s in range(S)]
        assert calls == [(tuple(imgs.shape), maps.stride(0))]
    assert torch.equal(got, torch.stack(solo))


# ---------------------------------------------------------------- the step


def _settings(cfg):
    """The tiny filter of tests/test_multistream.py: 60x80 detection, a 6x8
    grid, 10 motion samples, a 2-frame predictive window."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(60, 80),
            detector=cfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=10,
        ),
        smoother=cfg.PathSmootherSettings(predictive_samples=PREDICTIVE),
    )


def _yuv(luma):
    y = np.asarray(luma, np.float32)
    return np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)])


def _ticks():
    """Per tick and stream: (frame index, valid, drain).  N live ticks,
    then stream 0 stalls one tick (frozen) while 1 and 2 drain, then all
    drain."""
    ticks = [[(t, True, False)] * S for t in range(N)]
    ticks.append([(N - 1, False, False), (N - 1, False, True), (N - 1, False, True)])
    ticks += [[(N - 1, False, True)] * S] * PREDICTIVE
    return ticks


def _leaf_to_numpy(x):
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x))
    return np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    """One JAX run (one jit of the vmapped step) and one port run
    (MultiStreamFilter) over the same 3 clips and tick schedule."""
    rng = np.random.default_rng(0)
    clips, poses = [], []
    for _ in range(S):
        base = fixtures.make_texture(240, 240, rng)
        ps, _ = fixtures.shaky_path(N, rng, margin=60.0)
        poses.append(ps)
        clips.append([_yuv(fixtures.render_frame(base, p, SIZE)) for p in ps])

    fj = JComposite(filters=(lj.StabilizationFilter(settings=_settings(jcfg)),))
    ft = lt.CompositeFilter((lt.StabilizationFilter(settings=_settings(tcfg)),))
    multi = streams.MultiStreamFilter(ft, S)
    sj = jax.vmap(lambda _: fj.init(lj.FrameSpec(*SIZE, 3, YUV_J)))(jnp.arange(S))
    st = multi.init(lt.FrameSpec(*SIZE, 3, YUV_T), device="cpu")
    step = jax.jit(jax.vmap(lambda s, f, d: fj.step(s, f, drain=d)))
    jout, tout, inputs, carried = [], [], [], None
    for t, tick in enumerate(_ticks()):
        px = np.stack([clips[s][i] for s, (i, _, _) in enumerate(tick)])
        ts = np.array([i / 30.0 for i, _, _ in tick], np.float32)
        valid = np.array([v for _, v, _ in tick])
        drain = np.array([d for _, _, d in tick])
        inputs.append((px, ts, valid, drain))
        if t == CARRY_AT:
            carried = jax.tree.map(_leaf_to_numpy, sj)
        sj, oj = step(sj, lj.Frame(pixels=jnp.asarray(px), timestamp=jnp.asarray(ts),
                                   valid=jnp.asarray(valid), format=YUV_J), jnp.asarray(drain))
        st, ot = multi.step(st, _port_frame(px, ts, valid), torch.from_numpy(drain))
        jout.append(dict(valid=np.asarray(oj.valid), ts=np.asarray(oj.timestamp),
                         px=np.asarray(oj.pixels), corr=np.asarray(sj[0].correction.offsets),
                         trust=np.asarray(sj[0].trust), scene=np.asarray(sj[0].scene_quality)))
        tout.append(dict(valid=ot.valid.numpy(), ts=ot.timestamp.numpy(),
                         corr=st[0].correction.offsets.numpy()))
    return dict(poses=poses, jax=jout, torch=tout, carried=carried, inputs=inputs, filt=ft)


def _port_frame(px, ts, valid):
    return lt.Frame(pixels=torch.from_numpy(px), timestamp=torch.from_numpy(ts),
                    valid=torch.from_numpy(valid), format=YUV_T)


def test_batched_valid_flags_and_timestamps_equal(runs):
    """Per stream and tick, the stall and drain tail included."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        assert (ot["valid"] == oj["valid"]).all()
        assert (ot["ts"][ot["valid"]] == oj["ts"][oj["valid"]]).all()
    emitted = sum(o["valid"].astype(int) for o in runs["torch"])
    assert list(emitted) == [N] * S  # every live frame leaves the queue


def test_batched_corrections_agree(runs):
    """Per stream and tick, correction offsets within 2e-3 normalised units
    (the bound of tests/test_torch_stabilization.py; the packages draw
    different RANSAC samples)."""
    for oj, ot in zip(runs["jax"], runs["torch"]):
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3


def _output_track(runs, key, s):
    """Stream s: a scene point's input path and its output path, moved by
    the applied correction, read at its nearest node."""
    h, w = SIZE
    pt = np.array([[130.0, 110.0]], np.float32)
    x_in, y_out = [], []
    for t in range(N):
        o = runs[key][t]
        if not o["valid"][s]:
            continue
        xt = np.asarray(runs["poses"][s][t - PREDICTIVE].inverse().transform(jnp.asarray(pt)))[0]
        c = o["corr"][s]
        gy = int(np.clip(round(xt[1] / (h - 1)), 0, 1))
        gx = int(np.clip(round(xt[0] / (w - 1)), 0, 1))
        x_in.append(xt)
        y_out.append(xt - np.array([c[1, gy, gx] * (w - 1), c[0, gy, gx] * (h - 1)]))
    return np.array(x_in), np.array(y_out)


@pytest.mark.parametrize("metric", ["jitter", "ate"])
def test_batched_trajectory_quality_matches_jax(runs, metric):
    """Per stream, jitter and ATE of the output path within 0.8-1.25x of
    the JAX run's (the ORACLE_TRAJECTORY.json bound)."""
    for s in range(S):
        x_in, yj = _output_track(runs, "jax", s)
        _, yt = _output_track(runs, "torch", s)
        if metric == "jitter":
            mj, mt = metrics.jitter(yj), metrics.jitter(yt)
        else:
            ideal = metrics.smooth_path(x_in, sigma=4.0)
            mj, mt = metrics.ate(yj, ideal), metrics.ate(yt, ideal)
        assert 0.8 <= mt / mj <= 1.25, (s, mt, mj)


def test_batched_state_carried_from_jax(runs):
    """A batched JAX state (after CARRY_AT ticks) carried by interop and
    stepped once by the port: corrections within 1e-3, output pixels within
    1 LSB on >= 99.5% of pixels, trust and scene quality within 1e-5."""
    state = interop.composite_state_from_numpy(runs["carried"], runs["filt"].filters, "cpu")
    assert state[0].frames.data["pixels"].shape[0] == S
    px, ts, valid, drain = runs["inputs"][CARRY_AT]
    multi = streams.MultiStreamFilter(runs["filt"], S)
    state, out = multi.step(state, _port_frame(px, ts, valid), torch.from_numpy(drain))
    ref = runs["jax"][CARRY_AT]
    assert (out.valid.numpy() == ref["valid"]).all()
    assert np.abs(state[0].correction.offsets.numpy() - ref["corr"]).max() <= 1e-3
    d = np.abs(np.round(out.pixels.numpy() * 255.0) - np.round(ref["px"] * 255.0))
    assert (d <= 1).mean() >= 0.995
    assert np.abs(state[0].trust.numpy() - ref["trust"]).max() <= 1e-5
    assert np.abs(state[0].scene_quality.numpy() - ref["scene"]).max() <= 1e-5


# ------------------------------------------- the scaling chain and mesh mode

OUT = (128, 192)  # the chain's 2x scaler output


def _lockstep(fj, ft, n=N, seed=4, flat=False, tap=False):
    """`n` live ticks of S fresh shaky clips through jax.jit(jax.vmap(step))
    and the port's MultiStreamFilter; per tick the poses and both packages'
    (valid, pixels, stabilizer correction and, with `tap`, the second
    stage's state) per stream.  `flat` puts a flat patch in each texture's
    view."""
    rng = np.random.default_rng(seed)
    poses, clips = [], []
    for _ in range(S):
        base = np.array(fixtures.make_texture(240, 240, rng))
        if flat:
            base[80:130, 90:150] = 0.6
        ps, _ = fixtures.shaky_path(n, rng, margin=60.0)
        poses.append(ps)
        clips.append([_yuv(fixtures.render_frame(base, p, SIZE)) for p in ps])
    multi = streams.MultiStreamFilter(ft, S)
    sj = jax.vmap(lambda _: fj.init(lj.FrameSpec(*SIZE, 3, YUV_J)))(jnp.arange(S))
    st = multi.init(lt.FrameSpec(*SIZE, 3, YUV_T), device="cpu")
    step = jax.jit(jax.vmap(lambda s, f: fj.step(s, f)))
    valid = np.ones(S, bool)
    jout, tout = [], []
    for t in range(n):
        px = np.stack([clips[s][t] for s in range(S)])
        ts = np.full(S, t / 30.0, np.float32)
        sj, oj = step(sj, lj.Frame(pixels=jnp.asarray(px), timestamp=jnp.asarray(ts),
                                   valid=jnp.asarray(valid), format=YUV_J))
        st, ot = multi.step(st, _port_frame(px, ts, valid))
        jout.append(dict(valid=np.asarray(oj.valid), px=np.asarray(oj.pixels),
                         corr=np.asarray(sj[0].correction.offsets),
                         second=np.asarray(sj[1]) if tap else None))
        tout.append(dict(valid=ot.valid.numpy(), px=ot.pixels.numpy(),
                         corr=st[0].correction.offsets.numpy(),
                         second=st[1].numpy() if tap else None))
    return dict(poses=poses, jax=jout, torch=tout)


@pytest.fixture(scope="module")
def chain_runs():
    """The stabilizer -> 2x EASU + RCAS 0.8 chain, batched, in both packages."""
    def chain(pkg, cfg):
        return pkg.CompositeFilter((
            pkg.StabilizationFilter(settings=_settings(cfg)),
            pkg.ScalingFilter(cfg.ScalingFilterSettings(output_size=OUT, sharpness=0.8))))
    return _lockstep(chain(lj, jcfg), chain(lt, tcfg))


def test_batched_chain_matches_jax(chain_runs):
    """MultiStreamFilter over stabilizer -> ScalingFilter against
    jax.jit(jax.vmap(step)): per stream and tick equal valid flags,
    (3, 128, 192) outputs, corrections within 2e-3, and valid frames
    within max 4/255 and mean 1e-4 of JAX's (the chain bound of
    tests/test_torch_scaling.py: 1 LSB of the u8 queue, amplified by RCAS
    at most 4x)."""
    for oj, ot in zip(chain_runs["jax"], chain_runs["torch"]):
        assert (ot["valid"] == oj["valid"]).all()
        assert ot["px"].shape == oj["px"].shape == (S, 3, *OUT)
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3
        for s in np.flatnonzero(oj["valid"]):
            d = np.abs(ot["px"][s] - oj["px"][s])
            assert d.max() <= 4.0 / 255.0 and d.mean() <= 1e-4, (d.max(), d.mean())
    assert sum(o["valid"].sum() for o in chain_runs["torch"]) == S * (N - PREDICTIVE)


@pytest.fixture(scope="module")
def adb_cas_runs():
    """The JAX package's `vs + adb + cas` (the stabilizer, a tap of the
    deblocker's input, the deblocker, CAS; tests/test_torch_enhancement.py),
    batched, in both packages, over clips with flat patches."""
    import test_torch_enhancement as enh

    return _lockstep(lj.CompositeFilter(enh.chain_stages(lj, jcfg, _settings(jcfg))),
                     lt.CompositeFilter(enh.chain_stages(lt, tcfg, _settings(tcfg))), seed=6, flat=True,
                     tap=True)


def test_batched_adb_cas_chain_matches_jax(adb_cas_runs):
    """MultiStreamFilter over vs + adb + cas against jax.jit(jax.vmap(step)),
    S = 3: per stream and tick equal valid flags, corrections within 2e-3,
    and valid frames within the bounds of tests/test_torch_enhancement.py's
    `chain_compare` (max 4/255, held on at least 60% of the pixels; mean
    1e-4); the deblocker smooths some
    blocks."""
    import test_torch_enhancement as enh

    smoothed = held = total = 0
    for oj, ot in zip(adb_cas_runs["jax"], adb_cas_runs["torch"]):
        assert (ot["valid"] == oj["valid"]).all()
        assert ot["px"].shape == oj["px"].shape == (S, 3, *SIZE)
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3
        for s in np.flatnonzero(oj["valid"]):
            _, n_held, n, mj = enh.chain_compare(ot["px"][s], oj["px"][s], ot["second"][s], oj["second"][s])
            held, total = held + n_held, total + n
            smoothed += int((mj * 255.0 < enh.LEVELS).sum())
    assert smoothed > 0 and held >= 0.6 * total
    assert sum(o["valid"].sum() for o in adb_cas_runs["torch"]) == S * (N - PREDICTIVE)


MESH = (5, 7)


@pytest.fixture(scope="module")
def mesh_runs():
    """The stabilizer in mesh mode (a 5x7 mesh), batched, in both packages."""
    def mesh(pkg, cfg):
        s = _settings(cfg)
        return pkg.CompositeFilter((pkg.StabilizationFilter(settings=dataclasses.replace(
            s, tracker=dataclasses.replace(s.tracker, motion_resolution=MESH))),))
    return _lockstep(mesh(lj, jcfg), mesh(lt, tcfg), seed=5)


def _field_track(runs, key, s):
    """Stream s: a scene point's input path and its output path, moved by
    the correction field read bilinearly at the point."""
    h, w = SIZE
    pt = np.array([[130.0, 110.0]], np.float32)
    x_in, y_out = [], []
    for t, o in enumerate(runs[key]):
        if not o["valid"][s]:
            continue
        xt = np.asarray(runs["poses"][s][t - PREDICTIVE].inverse().transform(jnp.asarray(pt)))[0]
        c = o["corr"][s]
        fy = np.clip(xt[1] / (h - 1), 0, 1) * (MESH[0] - 1)
        fx = np.clip(xt[0] / (w - 1), 0, 1) * (MESH[1] - 1)
        y0, x0 = min(int(fy), MESH[0] - 2), min(int(fx), MESH[1] - 2)
        wy, wx = fy - y0, fx - x0
        v = (c[:, y0, x0] * (1 - wy) * (1 - wx) + c[:, y0, x0 + 1] * (1 - wy) * wx
             + c[:, y0 + 1, x0] * wy * (1 - wx) + c[:, y0 + 1, x0 + 1] * wy * wx)
        x_in.append(xt)
        y_out.append(xt - np.array([v[1] * (w - 1), v[0] * (h - 1)]))
    return np.array(x_in), np.array(y_out)


def test_batched_mesh_matches_jax(mesh_runs):
    """MultiStreamFilter over the mesh stabilizer against
    jax.jit(jax.vmap(step)), S = 3: per stream and tick equal valid flags
    and (2, 5, 7) corrections within 2e-3; per stream, jitter and ATE of
    the output path within 0.8-1.25x of JAX's (the ORACLE_TRAJECTORY_MESH
    bound) and the output smoother than the input."""
    for oj, ot in zip(mesh_runs["jax"], mesh_runs["torch"]):
        assert (ot["valid"] == oj["valid"]).all()
        assert ot["corr"].shape == (S, 2, *MESH)
        assert np.abs(ot["corr"] - oj["corr"]).max() <= 2e-3
    for s in range(S):
        x_in, yj = _field_track(mesh_runs, "jax", s)
        _, yt = _field_track(mesh_runs, "torch", s)
        assert metrics.jitter(yt) < metrics.jitter(x_in)
        ideal = metrics.smooth_path(x_in, sigma=4.0)
        for mt, mj in ((metrics.jitter(yt), metrics.jitter(yj)),
                       (metrics.ate(yt, ideal), metrics.ate(yj, ideal))):
            assert 0.8 <= mt / mj <= 1.25, (s, mt, mj)


@pytest.mark.parametrize("shared", ["none", "frame"])
@pytest.mark.parametrize("op", ["easu_scale", "rcas"])
def test_batched_scale_dispatch(monkeypatch, op, shared):
    """vmap over the port's easu_scale (``lvk::easu_scale``) and rcas
    (``lvk::rcas``) enters each batched rule ONCE a tick with the stacked
    shape, never once per stream, as the warp's does; the batched op takes
    a frame that every stream shares at stream stride 0, uncopied.  The
    results equal the solo calls."""
    from livevisionkit_tpu_torch.ops import easu as teasu
    from livevisionkit_tpu_torch.ops import rcas as trcas

    module, plain = (teasu, "easu_scale_batched_plain") if op == "easu_scale" else (
        trcas, "rcas_batched_plain")
    calls = []
    orig = getattr(module, plain)

    def spy(imgs, *args):
        calls.append((tuple(imgs.shape), imgs.stride(0)))
        return orig(imgs, *args)

    monkeypatch.setattr(module, plain, spy)
    imgs = torch.from_numpy(_batched_case(3)[0][:, :, :32, :48].copy())
    if op == "easu_scale":
        fn = lambda im: teasu.easu_scale(im, (64, 96), YUV_T)  # noqa: E731
        batched_op = torch.ops.lvk.easu_scale_batched
        extra = ([64, 96], YUV_T.value)
    else:
        fn = lambda im: trcas.rcas(im, 0.8)  # noqa: E731
        batched_op = torch.ops.lvk.rcas_batched
        extra = (0.8,)
    if shared == "frame":
        got = batched_op(imgs[1][None].expand(S, -1, -1, -1), *extra)
        assert calls == [((S, *imgs.shape[1:]), 0)]
        assert all(torch.equal(got[s], fn(imgs[1])) for s in range(S))
    else:
        multi = streams.MultiStreamFilter(lt.ScalingFilter(tcfg.ScalingFilterSettings(
            output_size=(64, 96) if op == "easu_scale" else None, sharpness=0.8 if op == "rcas" else 0.0)), S)
        frames = _port_frame(imgs.numpy(), np.zeros(S, np.float32), np.ones(S, bool))
        for _ in range(2):  # two ticks: two batched calls
            _, out = multi.step(multi.init(lt.FrameSpec(32, 48, 3, YUV_T), device="cpu"), frames)
        assert calls == [(tuple(imgs.shape), imgs.stride(0))] * 2
        assert torch.equal(out.pixels, torch.stack([fn(imgs[s]) for s in range(S)]))


@torch.library.custom_op("lvktest::unbatched_double", mutates_args=())
def _unbatched_double(x: torch.Tensor) -> torch.Tensor:
    """An op with no vmap rule."""
    return x * 2.0


class _DoublingFilter(lt.VideoFilter):
    def step(self, state, frame, *, drain=False):
        return state, frame.with_pixels(_unbatched_double(frame.pixels))


def test_op_without_batching_rule_raises():
    """An op of the chain without a batching rule raises inside
    MultiStreamFilter (the per-stream fallback is off) rather than running
    once per stream."""
    multi = streams.MultiStreamFilter(lt.CompositeFilter((lt.ScalingFilter(
        tcfg.ScalingFilterSettings(output_size=None, sharpness=0.8)), _DoublingFilter())), S)
    frames = _port_frame(np.random.default_rng(0).uniform(size=(S, 3, 16, 24)).astype(np.float32),
                         np.zeros(S, np.float32), np.ones(S, bool))
    with pytest.raises(RuntimeError):
        multi.step(multi.init(lt.FrameSpec(16, 24, 3, YUV_T), device="cpu"), frames)


# ---------------------------------------------------------------- the driver


def _bgr_clip(rng, n_frames, shift):
    """u8 (H, W, 3) BGR frames of a shaky path, as tests/test_multistream.py
    makes them."""
    base = fixtures.make_texture(240, 240, rng)
    poses, _ = fixtures.shaky_path(n_frames, rng, margin=60.0)
    clip = []
    for t, p in enumerate(poses):
        g = np.asarray(fixtures.render_frame(base, p, SIZE))
        u8 = np.clip(np.stack([g, g * 0.9, np.roll(g, shift, 1)], -1) * 255, 0, 255).astype(np.uint8)
        clip.append((u8, t / 30.0))
    return clip


def _serving_filter():
    return lt.StabilizationFilter(settings=_settings(tcfg))


def _solo_outputs(clip):
    """The oracle: one stream through the port's solo step, BGR -> YUV ->
    BGR as the driver converts, then `delay` drain bubbles."""
    filt = _serving_filter()
    state = filt.init(lt.FrameSpec(*SIZE, 3, YUV_T), device="cpu")
    outs = []
    ticks = [(u8, ts, True, False) for u8, ts in clip]
    ticks += [(clip[-1][0], 0.0, False, True)] * filt.delay
    for u8, ts, live, drain in ticks:
        x = torch.from_numpy(u8).to(torch.float32).permute(2, 0, 1) * (1.0 / 255.0)
        frame = lt.Frame.create(x, timestamp=ts, fmt=lt.PixelFormat.BGR, valid=live).reformat(YUV_T)
        state, out = filt.step(state, frame, drain=torch.tensor(drain))
        if bool(out.valid):
            outs.append((out.reformat(lt.PixelFormat.BGR).pixels.numpy(), float(out.timestamp)))
    return outs


def _f32_times(n):
    """The driver's timestamps of frames 0..n-1 (float32 seconds)."""
    return [float(np.float32(t / 30.0)) for t in range(n)]


def _collect(n):
    got = {i: [] for i in range(n)}
    lock = threading.Lock()

    def on_out(i, px, ts):
        with lock:
            got[i].append((time.perf_counter(), px.copy(), ts))

    return got, on_out


def test_stream_multi_matches_solo_steps():
    """Every input frame emits once the delay queues are flushed, in order,
    with the timestamps of the solo loop and its pixels: u8 re-quantization
    flips of the corrective warp, mixed by YUV -> BGR (at most 2.772/255),
    on at most 0.1% of pixels, as tests/test_multistream.py bounds them."""
    rng = np.random.default_rng(1)
    n_frames = 8
    clips = [_bgr_clip(rng, n_frames, s) for s in range(S)]
    got, on_out = _collect(S)
    stats = multistream.stream_multi(_serving_filter(), [iter(c) for c in clips], on_output=on_out,
                                     device="cpu")
    assert stats.frames_in == stats.frames_out == S * n_frames
    assert stats.stalls == 0 and stats.batches == n_frames + PREDICTIVE
    for i, clip in enumerate(clips):
        want = _solo_outputs(clip)
        assert len(got[i]) == len(want) == n_frames
        for (_, px, ts), (wpx, wts) in zip(got[i], want):
            assert ts == wts
            diff = np.abs(px - wpx)
            assert diff.max() <= 2.772 / 255.0 + 2e-5, diff.max()
            assert (diff > 2e-5).mean() <= 1e-3, (diff > 2e-5).mean()


def test_stream_multi_slow_stream_does_not_stall_batch():
    """A slow decoder gets valid=False bubbles (its state frozen) instead of
    stalling the other stream; none of its frames is lost, order holds, and
    the fast stream finishes before the slow one.  The slow reader hands
    over its first frame (the driver waits for every stream's first) and
    the rest only once the fast stream's last output has arrived: an
    ordering no load can break, where a sleeping reader raced a tick."""
    rng = np.random.default_rng(2)
    n_frames = 6
    clips = [_bgr_clip(rng, n_frames, 0), _bgr_clip(rng, n_frames, 1)]
    fast_done = threading.Event()
    released = []

    def slow_reader(clip):
        yield clip[0]
        released.append(fast_done.wait(timeout=120.0))
        yield from clip[1:]

    got, collect = _collect(2)

    def on_out(i, px, ts):
        collect(i, px, ts)
        if i == 0 and len(got[0]) == n_frames:
            fast_done.set()

    stats = multistream.stream_multi(
        _serving_filter(), [iter(clips[0]), slow_reader(clips[1])], on_output=on_out,
        slow_stream_timeout=0.05, inflight=0, queue_depth=1, device="cpu")
    assert released == [True], "the fast stream's last output never arrived while the slow one waited"
    assert stats.frames_in == stats.frames_out == 2 * n_frames
    assert len(got[0]) == len(got[1]) == n_frames
    assert stats.stalls > 0
    for i in (0, 1):
        ts = [t for (_, _, t) in got[i]]
        assert ts == sorted(ts) == _f32_times(n_frames)
    assert got[1][-1][0] > got[0][-1][0]


def test_stream_multi_uneven_stream_lengths():
    """A stream that ends early drains through bubbles while the other runs
    on; every frame of both emits, in order."""
    rng = np.random.default_rng(3)
    clips = [_bgr_clip(rng, 4, 0), _bgr_clip(rng, 8, 1)]
    got, on_out = _collect(2)
    stats = multistream.stream_multi(_serving_filter(), [iter(c) for c in clips], on_output=on_out,
                                     device="cpu")
    assert stats.frames_in == stats.frames_out == 12
    for i, n in ((0, 4), (1, 8)):
        assert [t for (_, _, t) in got[i]] == _f32_times(n)
