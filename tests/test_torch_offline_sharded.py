"""Temporal sharding of the port (`runtime/offline.process_clip_sharded`)
on meshes of repeated CPU devices: chunks on one device step as one
batched step.

Held by the JAX package's own rule (tests/test_offline_sharded.py:60-74)
against the port's serial `process_clip`, and (slow: a shard_map compile
of the JAX stabilizer) against the JAX package's `process_clip_sharded`.
Each chunk draws its own RANSAC hypotheses, so pixels agree up to warm-up
and sampling differences, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu.runtime import offline as joffline
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.parallel.streams import Mesh
from livevisionkit_tpu_torch.runtime import offline as toffline


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(rng, n, size=(96, 128)):
    """tests/test_offline_sharded.py's clip: (n, 1, H, W) f32 gray."""
    base = fixtures.make_texture(320, 320, rng)
    poses, _ = fixtures.shaky_path(n, rng, margin=80.0, drift_px=0.2, shake_px=2.0)
    return np.stack([np.asarray(fixtures.render_frame(base, p, size))[None] for p in poses])


def _settings(cfg):
    """tests/test_offline_sharded.py's filter settings, in either package."""
    return cfg.StabilizationFilterSettings(
        tracker=cfg.FrameTrackerSettings(
            detection_size=(96, 120),
            detector=cfg.FeatureDetectorSettings(grid_shape=(8, 10), fast_threshold_init=0.06),
            min_motion_samples=15,
        ),
        smoother=cfg.PathSmootherSettings(predictive_samples=4),
    )


def _time_mesh(n):
    return Mesh(["cpu"] * n, ("time",))


def _assert_matches(serial, sharded, n):
    """The JAX test's rule: >= 70% of frames valid in both, their
    timestamps within 1e-6, the mean over frames of the mean absolute pixel
    difference < 0.01."""
    sv, cv = np.asarray(serial.valid), np.asarray(sharded.valid)
    both = sv & cv
    assert both.sum() > n * 0.7, both.sum()
    np.testing.assert_allclose(np.asarray(serial.timestamp)[both],
                               np.asarray(sharded.timestamp)[both], atol=1e-6)
    a, b = np.asarray(serial.pixels)[both], np.asarray(sharded.pixels)[both]
    diff = np.abs(a - b).reshape(a.shape[0], -1).mean(axis=1)
    assert diff.mean() < 0.01, diff.mean()


def test_sharded_offline_matches_serial():
    """40 frames in 4 chunks (one 4-stream step a frame), overlap 12,
    against the serial loop."""
    n = 40
    clip = torch.from_numpy(_clip(np.random.default_rng(42), n))
    filt = lt.StabilizationFilter(settings=_settings(tcfg))
    _, serial = toffline.process_clip(filt, clip, lt.PixelFormat.GRAY, device="cpu")
    sharded = toffline.process_clip_sharded(filt, clip, lt.PixelFormat.GRAY, _time_mesh(4), overlap=12)
    assert sharded.pixels.shape == serial.pixels.shape
    _assert_matches(serial, sharded, n)
    # Each chunk's first outputs after its halo are valid; only the global
    # warm-up is lost.
    assert np.asarray(sharded.valid).sum() == n - filt.delay


def test_sharded_offline_scales_validity():
    """40 frames over 8 chunks (tail padding: 5 a chunk), overlap 10: every
    frame comes back once, in order, only the global warm-up invalid."""
    n = 40
    clip = torch.from_numpy(_clip(np.random.default_rng(43), n))
    filt = lt.StabilizationFilter(settings=_settings(tcfg))
    out = toffline.process_clip_sharded(filt, clip, lt.PixelFormat.GRAY, _time_mesh(8), overlap=10)
    assert out.pixels.shape[0] == n
    assert np.asarray(out.valid).sum() >= n - 8
    stamps = np.asarray(out.timestamp)[np.asarray(out.valid)]
    assert (np.diff(stamps) > 0).all()


@pytest.mark.slow
def test_sharded_offline_matches_jax_sharded():
    """Against the JAX package's process_clip_sharded on its 4-device
    virtual mesh (63 frames: a padded tail): the same valid flags and
    timestamps, and pixels by the JAX test's rule."""
    n = 63
    clip = _clip(np.random.default_rng(44), n)
    want = joffline.process_clip_sharded(
        lj.StabilizationFilter(settings=_settings(lj)), jnp.asarray(clip), lj.PixelFormat.GRAY,
        JMesh(np.asarray(jax.devices()[:4]), ("time",)), overlap=12)
    got = toffline.process_clip_sharded(lt.StabilizationFilter(settings=_settings(tcfg)),
                                        torch.from_numpy(clip), lt.PixelFormat.GRAY, _time_mesh(4),
                                        overlap=12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.timestamp.numpy(), np.asarray(want.timestamp), atol=1e-6)
    _assert_matches(want, got, n)
