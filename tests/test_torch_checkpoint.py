"""Port parity of stream-state snapshots (runtime/checkpoint.py): the
settings fingerprint equals the JAX package's for field-equal filters, a
resumed stream is bit-identical to an uninterrupted one (the RANSAC
generator's state included), and a snapshot taken under other settings or
other shapes is refused."""

import dataclasses

import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import presets as jpresets
from livevisionkit_tpu.runtime import checkpoint as jckpt
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import presets as tpresets
from livevisionkit_tpu_torch.runtime import checkpoint as tckpt


def _jax_flagship():
    """The JAX package's flagship filter, as __graft_entry__._flagship_filter
    builds it."""
    return lj.StabilizationFilter(settings=lj.StabilizationFilterSettings(
        tracker=lj.FrameTrackerSettings(
            detection_size=(272, 480),
            detector=lj.FeatureDetectorSettings(grid_shape=(17, 30)),
            min_motion_samples=75,
            motion=lj.MotionEstimationSettings(hypotheses=256),
        ),
        smoother=lj.PathSmootherSettings(predictive_samples=10),
        warp_filter="easu",
    ))


def _composite(pkg, presets):
    """Every filter kind in one chain.  The deblocker comes first: the JAX
    CompositeFilter rewrites a later deblocker's `pool_form` (an XLA
    lowering choice the port keeps as a field and ignores), which would
    make the two chains' settings differ."""
    params = pkg.CameraParameters(fx=420.0, fy=410.0, cx=160.0, cy=120.0, k1=-0.25, p2=-0.001)
    return pkg.CompositeFilter(filters=(
        pkg.DeblockingFilter(pkg.DeblockingFilterSettings(detection_levels=4)),
        pkg.LensCorrectionFilter(parameters=params, warp_filter="bilinear"),
        pkg.StabilizationFilter(settings=presets.stabilization_preset(qa="strict", smoothing=7)),
        pkg.CASFilter(pkg.CASFilterSettings(sharpness=0.3)),
        pkg.ScalingFilter(pkg.ScalingFilterSettings(output_size=(720, 1280), sharpness=0.5)),
        pkg.ConversionFilter(pkg.PixelFormat.RGB, extract_channel=1),
    ))


@pytest.mark.parametrize("which", ["flagship", "mesh", "composite"])
def test_fingerprint_equals_jax(which):
    if which == "flagship":
        jf, tf = _jax_flagship(), lt.flagship_filter()
    elif which == "mesh":
        jf = lj.StabilizationFilter(settings=jpresets.stabilization_preset(model="field"))
        tf = lt.StabilizationFilter(settings=tpresets.stabilization_preset(model="field"))
    else:
        jf, tf = _composite(lj, jpresets), _composite(lt, tpresets)
    got = tckpt.settings_fingerprint(tf)
    assert got == jckpt.settings_fingerprint(jf)
    assert len(got) == 16
    # A value-only change moves it.
    other = dataclasses.replace(lt.flagship_filter(), debug=True)
    assert tckpt.settings_fingerprint(other) != tckpt.settings_fingerprint(lt.flagship_filter())


def _filter():
    return lt.StabilizationFilter(settings=tcfg.StabilizationFilterSettings(
        tracker=tcfg.FrameTrackerSettings(
            detection_size=(48, 64),
            detector=tcfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=10,
        ),
        smoother=tcfg.PathSmootherSettings(predictive_samples=3),
    ))


def _frames(n=12, size=(48, 64)):
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(200, 200, rng)
    poses, _ = fixtures.shaky_path(n, rng, margin=50.0)
    return [lt.Frame.create(torch.from_numpy(np.array(fixtures.render_frame(base, p, size)))[None],
                            timestamp=t / 30.0, fmt=lt.PixelFormat.GRAY)
            for t, p in enumerate(poses)]


def test_snapshot_resume_identical(tmp_path):
    """Snapshot after 6 frames, load into a fresh init (another seed, so its
    generator must take the snapshot's state), run the next 6 frames: the
    outputs and the final states equal the uninterrupted run's."""
    filt = _filter()
    spec = lt.FrameSpec(48, 64, 1, lt.PixelFormat.GRAY)
    frames = _frames()
    state = filt.init(spec, device="cpu", seed=3)
    for f in frames[:6]:
        state, _ = filt.step(state, f)
    path = str(tmp_path / "snap.npz")
    tckpt.save_state(path, state, filt=filt)
    restored = tckpt.load_state(path, filt.init(spec, device="cpu", seed=99), filt=filt)
    assert restored.tracker.generator is not state.tracker.generator
    sa, sb = state, restored
    for f in frames[6:]:
        sa, oa = filt.step(sa, f)
        sb, ob = filt.step(sb, f)
        assert torch.equal(oa.pixels, ob.pixels) and bool(oa.valid) == bool(ob.valid)
    assert torch.equal(sa.correction.offsets, sb.correction.offsets)
    assert torch.equal(sa.tracker.generator.get_state(), sb.tracker.generator.get_state())


def test_snapshot_settings_mismatch_rejected(tmp_path):
    filt_a = _filter()
    filt_b = lt.StabilizationFilter(settings=dataclasses.replace(filt_a.settings,
                                                                 min_scene_quality=0.5))
    spec = lt.FrameSpec(48, 64, 1, lt.PixelFormat.GRAY)
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, filt_a.init(spec, device="cpu"), filt=filt_a)
    tckpt.load_state(path, filt_a.init(spec, device="cpu"), filt=filt_a)
    with pytest.raises(ValueError, match="configuration"):
        tckpt.load_state(path, filt_b.init(spec, device="cpu"), filt=filt_b)
    # A snapshot without a fingerprint loads into either.
    tckpt.save_state(path, filt_a.init(spec, device="cpu"))
    tckpt.load_state(path, filt_b.init(spec, device="cpu"), filt=filt_b)


def test_snapshot_shape_mismatch_rejected(tmp_path):
    filt = _filter()
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, filt.init(lt.FrameSpec(48, 64, 1, lt.PixelFormat.GRAY), device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(path, filt.init(lt.FrameSpec(64, 80, 1, lt.PixelFormat.GRAY), device="cpu"))
