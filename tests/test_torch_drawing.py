"""Port parity of the debug overlays on the CPU: each drawing op of
ops/drawing.py against the JAX package's (the pixels each sets equal, the
blended frame within 1e-6), and the stabilizer with `debug=True` against
JAX's over a shaky clip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.ops import drawing as jdraw
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.ops import drawing as tdraw
from livevisionkit_tpu_torch.parallel import streams

FORMATS = ["RGB", "BGR", "YUV", "GRAY", "UNKNOWN"]
COLOURS = ["red", "green", "blue", "yellow", "magenta", "white", "black"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fmt", FORMATS)
def test_colours_match_jax(fmt):
    """Every named colour in every format: JAX's float32 values."""
    for name in COLOURS:
        want = np.asarray(jdraw.colour(name, getattr(lj.PixelFormat, fmt)))
        got = np.asarray(tdraw.colour(name, getattr(lt.PixelFormat, fmt)), np.float32)
        assert np.array_equal(got, want), name


def _points(rng, n, h, w):
    """(x, y) points, some outside the frame (clipped), some invalid."""
    pts = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)], -1).astype(np.float32)
    return pts, rng.uniform(size=n) > 0.3


def _cases(rng, h, w):
    pts, valid = _points(rng, 24, h, w)
    offsets = rng.uniform(-0.05, 0.05, size=(2, 4, 5)).astype(np.float32)
    col = (0.9, 0.2, 0.4)
    return {
        "grid": (lambda m, img, c: m.draw_grid(img, (5, 7), c, thickness=1), col),
        "grid_thick": (lambda m, img, c: m.draw_grid(img, (3, 4), c, thickness=2), col),
        "points": (lambda m, img, c: m.draw_points(img, m_arr(m, pts), m_arr(m, valid), c), col),
        "crosses": (lambda m, img, c: m.draw_crosses(img, m_arr(m, pts), m_arr(m, valid), c), col),
        "rect": (lambda m, img, c: m.draw_rect(img, (0.1, 0.15), (0.85, 0.9), c), col),
        "motion_field": (lambda m, img, c: m.draw_motion_field(img, m_arr(m, offsets), c, scale=2.0), col),
    }


def m_arr(module, x):
    return jnp.asarray(x) if module is jdraw else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("op", ["grid", "grid_thick", "points", "crosses", "rect", "motion_field"])
def test_drawing_matches_jax(op):
    """The pixels an overlay sets are the same in both packages, and the
    blended (3, 37, 53) frame is within 1e-6 of JAX's."""
    rng = np.random.default_rng(0)
    h, w = 37, 53
    draw, col = _cases(rng, h, w)[op]
    img = rng.uniform(0.2, 0.8, size=(3, h, w)).astype(np.float32)
    want = np.asarray(draw(jdraw, jnp.asarray(img), jnp.asarray(col, jnp.float32)))
    got = draw(tdraw, torch.from_numpy(img), col).numpy()
    set_j, set_t = (want != img).any(0), (got != img).any(0)
    assert set_t.any() and np.array_equal(set_t, set_j)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_point_overlays_batch_over_streams():
    """The point scatter has a batching rule: MultiStreamFilter-style vmap
    of draw_crosses equals the per-stream calls."""
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.uniform(size=(3, 3, 20, 30)).astype(np.float32))
    pts = torch.from_numpy(np.stack([_points(rng, 10, 20, 30)[0] for _ in range(3)]))
    valid = torch.from_numpy(rng.uniform(size=(3, 10)) > 0.3)
    col = tdraw.colour("green", lt.PixelFormat.YUV)
    got = streams.batched(lambda im, p, v: tdraw.draw_crosses(im, p, v, col))(imgs, pts, valid)
    want = torch.stack([tdraw.draw_crosses(imgs[s], pts[s], valid[s], col) for s in range(3)])
    assert torch.equal(got, want)


SIZE = (96, 128)
N, PREDICTIVE = 10, 2
OVERLAYS = ("green", "magenta", "yellow")


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


def _overlay(px, name):
    """Pixels of a YUV frame that hold the named overlay colour (the clip's
    chroma is 0.5, which no overlay colour has)."""
    col = np.asarray(tdraw.colour(name, lt.PixelFormat.YUV), np.float32)
    return (px == col[:, None, None]).all(0)


@pytest.fixture(scope="module")
def debug_runs():
    """The stabilizer of both packages with debug=True over the clip of
    tests/test_torch_scaling.py's chain (one jit of the JAX step), and the
    port's plain stabilizer from the same seed beside it."""
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(220, 260, rng)
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    fj = lj.StabilizationFilter(settings=_settings(jcfg), debug=True)
    ft = lt.StabilizationFilter(settings=_settings(tcfg), debug=True)
    fp = lt.StabilizationFilter(settings=_settings(tcfg))
    sj = fj.init(lj.FrameSpec(*SIZE, 3, lj.PixelFormat.YUV))
    st = ft.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    sp = fp.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu")
    step = jax.jit(fj.step)
    out = []
    for t, p in enumerate(poses):
        y = np.array(fixtures.render_frame(base, p, SIZE), np.float32)
        px = np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)])
        sj, oj = step(sj, lj.Frame.create(jnp.asarray(px), timestamp=t / 30.0, fmt=lj.PixelFormat.YUV))
        ft_in = lt.Frame.create(torch.from_numpy(px), timestamp=t / 30.0, fmt=lt.PixelFormat.YUV)
        st, ot = ft.step(st, ft_in)
        sp, op = fp.step(sp, ft_in)
        out.append((bool(oj.valid), np.asarray(oj.pixels), bool(ot.valid), ot.pixels.numpy(), op.pixels.numpy()))
    return out


def test_debug_overlays_match_jax(debug_runs):
    """debug=True against JAX: per valid frame the stable-region rectangle
    on the same pixels, the tracked-point crosses on the same pixels but
    for at most 2% (a point whose coordinate sits on an integer may truncate
    the other way), the motion-field crosses (at the RANSAC fit's nodes,
    within 2e-3 of JAX's) on the same pixels but for at most 25%, and the
    pixels under no overlay within the chain bound (max 4/255, mean 1e-4)."""
    n_valid = 0
    for vj, pj, vt, pt, _ in debug_runs:
        assert vt == vj
        if not vj:
            continue
        n_valid += 1
        masks = {name: (_overlay(pt, name), _overlay(pj, name)) for name in OVERLAYS}
        for name, bound in (("yellow", 0.0), ("green", 0.02), ("magenta", 0.25)):
            mt, mj = masks[name]
            assert mt.any() and mj.any(), name
            assert (mt ^ mj).sum() <= bound * (mt | mj).sum(), (name, (mt ^ mj).sum(), (mt | mj).sum())
        under = np.zeros(SIZE, bool)
        for mt, mj in masks.values():
            under |= mt | mj
        d = np.abs(pt - pj)[:, ~under]
        assert d.max() <= 4.0 / 255.0 and d.mean() <= 1e-4, (d.max(), d.mean())
    assert n_valid == N - PREDICTIVE


def test_debug_changes_only_overlay_pixels(debug_runs):
    """Against the port's plain stabilizer from the same seed: a pixel
    changes only where an overlay is drawn, and there it holds exactly the
    overlay's colour."""
    for _, _, vt, pt, pp in debug_runs:
        if not vt:
            continue
        under = np.zeros(SIZE, bool)
        for name in OVERLAYS:
            under |= _overlay(pt, name)
        changed = (pt != pp).any(0)
        assert changed.any() and not (changed & ~under).any()
