"""Port parity of the streaming runtime: `runtime/stream.stream` against
the JAX package's `stream` on the same u8 BGR clips (identity and a
deterministic CAS + conversion chain), its pipeline contract (stabilizer
delay and order, reader errors, writer aborts, latency quantiles, the HUD,
per-filter profile keys), and `runtime/offline.process_clip` against the
JAX `process_clip` and against the port's own frame loop."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu.runtime import hud as jhud
from livevisionkit_tpu.runtime import offline as joffline
from livevisionkit_tpu.runtime import stream as jstream
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.runtime import hud as thud
from livevisionkit_tpu_torch.runtime import offline as toffline
from livevisionkit_tpu_torch.runtime import stream as tstream

SIZE = (48, 64)


def _clip_u8(seed, n=8, size=SIZE):
    """u8 (H, W, 3) BGR frames of a shaky path with distinct channels."""
    rng = np.random.default_rng(seed)
    base = fixtures.make_texture(200, 200, rng)
    poses, _ = fixtures.shaky_path(n, rng, margin=50.0, shake_px=2.0)
    frames = []
    for p in poses:
        g = np.asarray(fixtures.render_frame(base, p, size))
        bgr = np.stack([g, 0.2 + 0.6 * g, np.roll(g, 3, 1)], -1)
        frames.append(np.clip(bgr * 255.0 + 0.5, 0, 255).astype(np.uint8))
    return frames


def _reader(frames):
    return ((f, t / 30.0) for t, f in enumerate(frames))


def _run_both(jfilt, tfilt, frames, **kw):
    jouts, touts = [], []
    js = jstream.stream(jfilt, _reader(frames), on_output=lambda px, ts: jouts.append((px.copy(), ts)),
                        **kw)
    ts_ = tstream.stream(tfilt, _reader(frames), on_output=lambda px, ts: touts.append((px.copy(), ts)),
                         device="cpu", **kw)
    return js, jouts, ts_, touts


def _cas_conv(pkg):
    return pkg.CompositeFilter(filters=(
        pkg.CASFilter(pkg.CASFilterSettings(sharpness=0.6)),
        pkg.ConversionFilter(pkg.PixelFormat.RGB),
    ))


def test_stream_identity_matches_jax():
    """Identity through both drivers: BGR -> YUV -> BGR on each device,
    equal within 1e-6, in order, with the same float32 timestamps."""
    frames = _clip_u8(0)
    js, jouts, ts_, touts = _run_both(lj.CompositeFilter(filters=(lj.IdentityFilter(),)),
                                      lt.CompositeFilter(filters=(lt.IdentityFilter(),)), frames)
    assert ts_.frames_in == js.frames_in == len(frames)
    assert ts_.frames_out == js.frames_out == len(frames)
    for (jp, jt), (tp, tt) in zip(jouts, touts):
        assert tp.shape == (3, *SIZE) and tp.dtype == np.float32
        assert tt == jt
        np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)


def test_stream_cas_conversion_chain_matches_jax():
    """A deterministic chain (CAS 0.6, then a conversion to RGB) through both
    drivers: equal within 1e-5."""
    frames = _clip_u8(1, n=6)
    js, jouts, ts_, touts = _run_both(_cas_conv(lj), _cas_conv(lt), frames)
    assert ts_.frames_out == js.frames_out == len(frames)
    for (jp, jt), (tp, tt) in zip(jouts, touts):
        assert tt == jt
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)


def _tiny_stabilizer(predictive=3):
    return lt.StabilizationFilter(settings=tcfg.StabilizationFilterSettings(
        tracker=tcfg.FrameTrackerSettings(
            detection_size=(48, 64),
            detector=tcfg.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.06),
            min_motion_samples=10,
        ),
        smoother=tcfg.PathSmootherSettings(predictive_samples=predictive),
    ))


def test_stream_stabilizer_delay_and_order():
    """A 3-frame delay: outputs are frames 0..n-4, in order, finite."""
    frames = _clip_u8(2, n=10)
    outs = []
    stats = tstream.stream(_tiny_stabilizer(), _reader(frames),
                           on_output=lambda px, ts: outs.append((px, ts)), device="cpu")
    assert stats.frames_in == len(frames)
    assert stats.frames_out == len(frames) - 3
    assert [ts for _, ts in outs] == [float(np.float32(t / 30.0)) for t in range(len(frames) - 3)]
    assert all(np.isfinite(px).all() and px.shape == (3, *SIZE) for px, _ in outs)


def test_stream_reader_exception_surfaces():
    frames = _clip_u8(3, n=6)

    def bad_reader():
        for t, f in enumerate(frames):
            if t == 3:
                raise RuntimeError("decode exploded")
            yield f, t / 30.0

    with pytest.raises(RuntimeError, match="decode exploded"):
        tstream.stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), bad_reader(),
                       on_output=lambda px, ts: None, device="cpu")


def test_stream_writer_abort_does_not_strand_reader():
    """A failing writer aborts the pipeline; the reader, blocked on a full
    2-deep queue of an endless source, unblocks and the call returns."""
    f = _clip_u8(4, n=1)[0]

    def endless_reader():
        for t in itertools.count():
            yield f, t / 30.0

    def bad_writer(px, ts):
        raise IOError("encoder died")

    with pytest.raises(IOError, match="encoder died"):
        tstream.stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), endless_reader(),
                       on_output=bad_writer, queue_depth=2, device="cpu")


def test_stream_latency_quantiles():
    frames = _clip_u8(5, n=12)
    stats = tstream.stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), _reader(frames),
                           on_output=lambda px, ts: None, device="cpu")
    q = stats.latency_quantiles()
    assert set(q) == {"p50_ms", "p95_ms", "p99_ms"}
    assert 0 < q["p50_ms"] <= q["p95_ms"] <= q["p99_ms"]
    assert len(stats.latencies) == stats.frames_out
    assert tstream.StreamStats().latency_quantiles() == {}


@pytest.mark.parametrize("frame_ms", [2.0, 9.0])
def test_frame_time_hud_matches_jax(frame_ms):
    """The HUD stamp (text and budget bar, green within the 6 ms budget,
    red over) equals the JAX package's on the same array."""
    img = np.random.default_rng(6).uniform(0.2, 0.8, size=(3, 80, 160)).astype(np.float32)
    want = jhud.draw_frame_time_hud(img.copy(), frame_ms=frame_ms, budget_ms=6.0)
    got = thud.draw_frame_time_hud(img.copy(), frame_ms=frame_ms, budget_ms=6.0)
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(got, want)


def test_stream_hud_on_every_output():
    frames = [np.full((80, 160, 3), 128, np.uint8)] * 8
    outs = []
    tstream.stream(lt.CompositeFilter(filters=(lt.IdentityFilter(),)), _reader(frames),
                   on_output=lambda px, ts: outs.append(px.copy()), hud_budget_ms=6.0,
                   device="cpu")
    assert len(outs) == 8
    for px in outs:
        assert (np.abs(px[:, 6:30, 6:80] - 128 / 255.0) > 0.35).any()


def test_profile_filters_keys_match_jax():
    """profile_filters times each chain element under the same "i:name"
    keys as the JAX driver, one sample per frame, and the outputs stay
    those of the fused run."""
    frames = _clip_u8(7, n=5)
    js, jouts, ts_, touts = _run_both(_cas_conv(lj), _cas_conv(lt), frames, profile_filters=True)
    assert list(ts_.filter_times) == list(js.filter_times) == ["0:CASFilter", "1:ConversionFilter"]
    for watch in ts_.filter_times.values():
        assert watch.count == len(frames) and watch.average() > 0
    for (jp, _), (tp, _) in zip(jouts, touts):
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)


def _yuv_clip(seed, n=6):
    """(T, 3, H, W) f32 YUV planes."""
    rng = np.random.default_rng(seed)
    base = fixtures.make_texture(200, 200, rng)
    poses, _ = fixtures.shaky_path(n, rng, margin=50.0, shake_px=2.0)
    ys = [np.asarray(fixtures.render_frame(base, p, SIZE)) for p in poses]
    return np.stack([np.stack([y, 0.5 + 0.1 * y, 0.5 - 0.1 * y]) for y in ys]).astype(np.float32)


def test_process_clip_matches_jax_on_a_deterministic_chain():
    clip = _yuv_clip(8)
    chain = lambda pkg: pkg.CompositeFilter(filters=(  # noqa: E731
        pkg.CASFilter(pkg.CASFilterSettings(sharpness=0.8)), pkg.ConversionFilter(pkg.PixelFormat.RGB)))
    _, jout = joffline.process_clip(chain(lj), jnp.asarray(clip), lj.PixelFormat.YUV)
    _, tout = toffline.process_clip(chain(lt), torch.from_numpy(clip), lt.PixelFormat.YUV,
                                    device="cpu")
    assert tout.pixels.shape == (len(clip), 3, *SIZE) and tout.format is lt.PixelFormat.RGB
    np.testing.assert_allclose(tout.pixels.numpy(), np.asarray(jout.pixels), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tout.timestamp.numpy(), np.asarray(jout.timestamp))
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))


def test_process_clip_equals_the_frame_loop_for_the_stabilizer():
    """The stabilizer over a clip: bit-equal to stepping it frame by frame
    from the same seed, valid flags from frame `delay` on."""
    clip = torch.from_numpy(_yuv_clip(9, n=8))
    filt = _tiny_stabilizer(predictive=2)
    spec = lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV)
    state, out = toffline.process_clip(filt, clip, lt.PixelFormat.YUV, device="cpu",
                                       state=filt.init(spec, device="cpu", seed=5))
    ref_state = filt.init(spec, device="cpu", seed=5)
    for t in range(len(clip)):
        ref_state, ref = filt.step(ref_state, lt.Frame.create(clip[t], timestamp=t / 30.0,
                                                              fmt=lt.PixelFormat.YUV))
        assert torch.equal(out.pixels[t], ref.pixels)
        assert bool(out.valid[t]) == bool(ref.valid) == (t >= filt.delay)
        assert float(out.timestamp[t]) == float(ref.timestamp)
    assert torch.equal(state.correction.offsets, ref_state.correction.offsets)
