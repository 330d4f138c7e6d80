"""Port parity of the enhancement filters on the CPU: the deblocker's
resample helpers, the DeblockingFilter, CAS and the CASFilter, the
ConversionFilter, and the stabilizer -> deblocker -> CAS chain (the JAX
package's `vs + adb + cas`) against the JAX package, with a JAX chain state
carried into the port mid-stream; and the port alone against the behaviour
tests of tests/test_enhancement.py and tests/test_cas.py.

The deblocker's keep map is min(floor(255 measure), L) / L per block.  Two
sums of one block taken in another order differ by ~1e-7, and where
255 measure lies on an integer <= L (on u8-quantized input it does: a
block half at a and half at a + 2/255 measures exactly 1/255) the floor
flips and the block's keep moves by 1/L.  Those blocks are excluded, and
counted, by their JAX measure: within 1e-4 of such an integer.  Outputs
are compared away from them, grown by half a block: the bilinear upsample
of the keep map carries a block's keep that far into its neighbours.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu as lj
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.ops import cas as jcas
from livevisionkit_tpu.ops import color as jcolor
from livevisionkit_tpu.ops import resample as jres
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch import interop
from livevisionkit_tpu_torch.filters import deblocking as tdeblock
from livevisionkit_tpu_torch.ops import cas as tcas
from livevisionkit_tpu_torch.ops import rcas as trcas
from livevisionkit_tpu_torch.ops import resample as tres

BLOCK, LEVELS = 16, 3
NEAR = 1e-4  # |255 measure - integer| below which a block's floor may flip


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fmt(pkg, name):
    return getattr(pkg.PixelFormat, name)


# ------------------------------------------------------- resample helpers


def test_median_blur_bit_equal():
    """The exact median of the 25 shifted views equals the JAX selection
    network bit for bit, (C, H, W) and (H, W), 3x3 and 5x5."""
    rng = np.random.default_rng(0)
    for shape, k in (((3, 20, 36), 5), ((17, 23), 5), ((2, 9, 11), 3)):
        x = rng.uniform(size=shape).astype(np.float32)
        want = np.asarray(jres.median_blur(jnp.asarray(x), k))
        got = tres.median_blur(torch.from_numpy(x), k).numpy()
        assert np.array_equal(got, want), shape


@pytest.mark.parametrize("op", ["avg_pool", "upsample_linear", "upsample_nearest"])
def test_resample_helpers_match_jax(op):
    """avg_pool (both JAX forms), the integer bilinear upsample (factors 4
    and 16, on the JAX polyphase form and on jax.image.resize) within 1e-6;
    the nearest upsample equal."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3, 16, 24)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if op == "avg_pool":
        for b in (4, 8):
            got = tres.avg_pool(xt, b).numpy()
            for want in (jres.avg_pool(xj, b), jres.avg_pool_rw(xj, b)):
                np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    elif op == "upsample_linear":
        for f in (4, 16):
            got = tres.upsample_linear_int(xt, (f, f)).numpy()
            np.testing.assert_allclose(got, np.asarray(jres.upsample_linear_int(xj, (f, f))), atol=1e-6, rtol=0)
            ref = jax.image.resize(xj, (3, 16 * f, 24 * f), method="linear", antialias=False)
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)
    else:
        got = tres.upsample_nearest_int(xt, 4).numpy()
        assert np.array_equal(got, np.asarray(jres.upsample_nearest_int(xj, 4)))


# ------------------------------------------------------------ deblocking


def _blocky_u8(rng, h, w, c):
    """u8-quantized blocky frames: each 16x16 block of a texture is left
    textured (1/2), flattened to its mean (3/8) or split into halves 2/255
    apart (1/8: 255 measure exactly 1, the floor's trap), all on the 1/255
    grid."""
    tex = np.stack([np.array(fixtures.make_texture(h, w, rng)) for _ in range(c)])
    out = tex.copy()
    for by in range(0, h - BLOCK + 1, BLOCK):
        for bx in range(0, w - BLOCK + 1, BLOCK):
            kind = rng.choice(3, p=(0.5, 0.375, 0.125))
            blk = tex[:, by:by + BLOCK, bx:bx + BLOCK]
            if kind == 1:
                out[:, by:by + BLOCK, bx:bx + BLOCK] = blk.mean(axis=(1, 2), keepdims=True)
            elif kind == 2:
                base = np.round(blk.mean() * 255.0) / 255.0
                out[:, by:by + BLOCK, bx:bx + BLOCK] = base
                out[:, by:by + BLOCK, bx + BLOCK // 2:bx + BLOCK] = base + 2.0 / 255.0
    return np.round(np.clip(out, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0


def _random(rng, h, w, c):
    return np.stack([np.array(fixtures.make_texture(h, w, rng)) for _ in range(c)])


def _jax_measure(px, fmt):
    """JAX's blockiness measure over the edge-padded frame, as its step
    takes it (the padded extent a whole number of blocks)."""
    c, h, w = px.shape
    ph, pw = -(-h // BLOCK) * BLOCK, -(-w // BLOCK) * BLOCK
    p = jnp.pad(jnp.asarray(px), ((0, 0), (0, ph - h), (0, pw - w)), mode="edge")
    gray = jcolor.luma(p, fmt)
    ref = jres.upsample_nearest_int(jres.avg_pool(gray, BLOCK), BLOCK)
    return np.asarray(jres.avg_pool(jnp.abs(gray - ref), BLOCK))


def _near_integer(measure):
    """Blocks whose 255 measure lies within NEAR of an integer 1..LEVELS
    (a measure is >= 0, so 0 is no trap)."""
    m = measure * 255.0
    return (np.abs(m - np.round(m)) < NEAR) & (np.round(m) >= 1) & (np.round(m) <= LEVELS)


def _away(near, h, w):
    """(H, W) mask of the pixels away from the near blocks: a pixel of block
    i blends the keep of i and of the neighbour on its side (the bilinear
    upsample by 16, half-pixel centres), so a block reaches half a block
    into its neighbours."""
    hit = np.kron(near, np.ones((BLOCK, BLOCK), bool)).astype(bool)
    r = BLOCK // 2
    grown = np.zeros((hit.shape[0] + 2 * r, hit.shape[1] + 2 * r), bool)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            grown[dy:dy + hit.shape[0], dx:dx + hit.shape[1]] |= hit
    return ~grown[r:r + h, r:r + w]


DEBLOCK_CASES = [((72, 120), "random"), ((72, 120), "blocky_u8"),
                 ((64, 128), "random"), ((64, 128), "blocky_u8")]


@pytest.mark.parametrize("fmt", ["YUV", "RGB", "GRAY"])
@pytest.mark.parametrize("size,kind", DEBLOCK_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_deblocker_matches_jax(size, kind, fmt):
    """DeblockingFilter.step against JAX (72 % 16 = 8: the edge pad and the
    passed-through partial border; 64x128 whole blocks): the output within
    1e-5 away from the near-integer blocks (at least 40% of the frame), and
    equal to the input on the partial border."""
    rng = np.random.default_rng(zlib.crc32(f"{size}{kind}{fmt}".encode()))
    h, w = size
    c = 1 if fmt == "GRAY" else 3
    px = (_random if kind == "random" else _blocky_u8)(rng, h, w, c)
    _, oj = lj.DeblockingFilter().step((), lj.Frame.create(jnp.asarray(px), fmt=_fmt(lj, fmt)))
    _, ot = lt.DeblockingFilter().step((), lt.Frame.create(torch.from_numpy(px), fmt=_fmt(lt, fmt)))
    near = _near_integer(_jax_measure(px, _fmt(lj, fmt)))
    away = _away(near, h, w)
    assert away.mean() >= 0.4, (near.sum(), away.mean())
    d = np.abs(ot.pixels.numpy() - np.asarray(oj.pixels))
    assert d[:, away].max() <= 1e-5, d[:, away].max()
    fh, fw = (h // BLOCK) * BLOCK, (w // BLOCK) * BLOCK
    np.testing.assert_array_equal(ot.pixels.numpy()[:, fh:], px[:, fh:])
    np.testing.assert_array_equal(ot.pixels.numpy()[:, :, fw:], px[:, :, fw:])


@pytest.mark.parametrize("size,kind", DEBLOCK_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_influence_map_matches_jax(size, kind):
    """influence_map against JAX: per block, keep equal on every block whose
    255 measure is not within 1e-4 of an integer 1..L; the (H, W) map
    within 1e-6 away from those blocks, 0 on the border."""
    rng = np.random.default_rng(7)
    h, w = size
    px = (_random if kind == "random" else _blocky_u8)(rng, h, w, 3)
    fj = lj.Frame.create(jnp.asarray(px), fmt=lj.PixelFormat.YUV)
    ft = lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.YUV)
    fh, fw = (h // BLOCK) * BLOCK, (w // BLOCK) * BLOCK
    gray = jnp.asarray(px[0, :fh, :fw])
    ref = jres.upsample_nearest_int(jres.avg_pool_rw(gray, BLOCK), BLOCK)
    mj = np.asarray(jres.avg_pool_rw(jnp.abs(gray - ref), BLOCK))
    near = _near_integer(mj)
    kj = np.minimum(np.floor(mj * 255.0), LEVELS) / LEVELS
    kt = tdeblock.keep_blocks(tdeblock.block_measure(torch.from_numpy(px[0, :fh, :fw]), BLOCK), LEVELS).numpy()
    assert np.array_equal(kt[~near], kj[~near].astype(np.float32))
    if kind == "blocky_u8":
        assert near.any()  # the trap is on the path
    inf_j = np.asarray(lj.DeblockingFilter().influence_map(fj))
    inf_t = lt.DeblockingFilter().influence_map(ft).numpy()
    assert inf_t.shape == (h, w)
    away = np.zeros((h, w), bool)
    away[:fh, :fw] = _away(near, fh, fw)
    np.testing.assert_allclose(inf_t[away], inf_j[away], atol=1e-6, rtol=0)
    assert (inf_t[fh:] == 0).all() and (inf_t[:, fw:] == 0).all()


@pytest.mark.parametrize("filt", ["deblock", "cas"])
def test_filters_batch_over_streams(filt):
    """MultiStreamFilter over the deblocker (72x120: the edge pad, the
    median, the upsamples and the partial border's `where` under vmap) and
    CAS equals the filter stepped per stream, bit for bit."""
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter

    f = lt.DeblockingFilter() if filt == "deblock" else lt.CASFilter()
    px = np.stack([_blocky_u8(np.random.default_rng(s), 72, 120, 3) for s in range(3)])
    frames = lt.Frame(pixels=torch.from_numpy(px), timestamp=torch.zeros(3),
                      valid=torch.ones(3, dtype=torch.bool), format=lt.PixelFormat.YUV)
    multi = MultiStreamFilter(f, 3)
    _, out = multi.step(multi.init(lt.FrameSpec(72, 120, 3, lt.PixelFormat.YUV), device="cpu"), frames)
    for s in range(3):
        _, want = f.step((), lt.Frame.create(torch.from_numpy(px[s]), fmt=lt.PixelFormat.YUV))
        assert torch.equal(out.pixels[s], want.pixels)


def _blocky_gray(rng, h=64, w=96):
    tex = np.array(fixtures.make_texture(h, w, rng))
    blocky = tex.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK).mean((1, 3))
    return tex, np.repeat(np.repeat(blocky, BLOCK, 0), BLOCK, 1).astype(np.float32)


def _gray_frame(x):
    return lt.Frame.create(torch.from_numpy(np.array(x, np.float32))[None], fmt=lt.PixelFormat.GRAY)


def test_deblocker_smooths_blocky_regions():
    """The port alone (tests/test_enhancement.py:24-34): flat blocks are
    fully smoothed, and block-boundary steps shrink below 0.7x."""
    _, blocky = _blocky_gray(np.random.default_rng(42))
    _, out = lt.DeblockingFilter().step((), _gray_frame(blocky))
    edge_in = np.abs(np.diff(blocky, axis=1))[:, 15::16].mean()
    edge_out = np.abs(np.diff(out.pixels[0].numpy(), axis=1))[:, 15::16].mean()
    assert edge_out < 0.7 * edge_in


def test_deblocker_preserves_detail():
    """(tests/test_enhancement.py:37-45) High-detail blocks keep 1: the
    output equals the input within 1e-3."""
    tex, _ = _blocky_gray(np.random.default_rng(42))
    detail = np.clip((tex - 0.5) * 2.0 + 0.5, 0, 1)
    _, out = lt.DeblockingFilter().step((), _gray_frame(detail))
    np.testing.assert_allclose(out.pixels[0].numpy(), detail, atol=1e-3)


def test_deblocker_partial_border_untouched():
    """(tests/test_enhancement.py:48-54) A 70x100 frame: the rows and
    columns past the whole blocks pass through within 1e-7."""
    tex = np.array(fixtures.make_texture(70, 100, np.random.default_rng(42)))
    _, out = lt.DeblockingFilter().step((), _gray_frame(tex))
    out_np = out.pixels[0].numpy()
    np.testing.assert_allclose(out_np[64:, :], tex[64:, :], atol=1e-7)
    np.testing.assert_allclose(out_np[:, 96:], tex[:, 96:], atol=1e-7)


def test_deblocker_influence_map_flat_blocks():
    """(tests/test_enhancement.py:57-62) The map of a blocky frame: (H, W),
    flat blocks fully smoothed."""
    _, blocky = _blocky_gray(np.random.default_rng(42))
    inf = lt.DeblockingFilter().influence_map(_gray_frame(blocky)).numpy()
    assert inf.shape == (64, 96) and inf.max() > 0.9


def test_deblocker_settings_ignore_pool_form():
    """pool_form is kept for field equality and changes nothing."""
    px = _blocky_u8(np.random.default_rng(3), 72, 120, 3)
    outs = [lt.DeblockingFilter(tcfg.DeblockingFilterSettings(pool_form=f)).step(
        (), lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.YUV))[1].pixels
        for f in ("auto", "reshape", "reduce_window")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ------------------------------------------------------------------- CAS


def _cas_oracle(img_chw, sharpness):
    """Scalar transcription of CasFilter (ffx_cas_mod.h:57-168), exact
    rcp/sqrt, as tests/test_cas.py has it."""
    peak = -1.0 / (8.0 + (5.0 - 8.0) * np.clip(sharpness, 0.0, 1.0))
    _, h_, w_ = img_chw.shape
    p = np.pad(img_chw, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = np.empty_like(img_chw)
    for y in range(h_):
        for x in range(w_):
            n = p[:, y:y + 3, x:x + 3].transpose(1, 2, 0)
            a, b, c = n[0]
            d, e, f = n[1]
            g, h, i = n[2]
            mn = np.minimum.reduce([d, e, f, b, h])
            mn = mn + np.minimum.reduce([mn, a, c, g, i])
            mx = np.maximum.reduce([d, e, f, b, h])
            mx = mx + np.maximum.reduce([mx, a, c, g, i])
            amp = np.sqrt(np.clip(np.minimum(mn, 2.0 - mx) / np.maximum(mx, 1e-6), 0.0, 1.0))
            wgt = amp * peak
            out[:, y, x] = np.clip(((b + d + f + h) * wgt + e) / (4.0 * wgt + 1.0), 0.0, 1.0)
    return out


@pytest.mark.parametrize("sharpness", [0.0, 0.5, 0.8, 1.0])
def test_cas_matches_jax(sharpness):
    """ops/cas.cas against JAX's within 1e-6, (C, H, W) and (H, W)."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0.0, 1.0, size=(3, 24, 40)).astype(np.float32)
    img[:, 5:12, 8:20] = 0.9
    want = np.asarray(jcas.cas(jnp.asarray(img), sharpness))
    got = tcas.cas(torch.from_numpy(img), sharpness).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got2 = tcas.cas(torch.from_numpy(img[1]), sharpness).numpy()
    np.testing.assert_allclose(got2, want[1], atol=1e-6, rtol=0)


def test_cas_matches_ffx_oracle():
    """(tests/test_cas.py:45-50) Against the scalar ffx transcription, 2e-6."""
    rng = np.random.default_rng(42)
    img = rng.uniform(0.0, 1.0, size=(3, 12, 14)).astype(np.float32)
    for sharp in (0.0, 0.5, 1.0):
        got = tcas.cas(torch.from_numpy(img), sharp).numpy()
        np.testing.assert_allclose(got, _cas_oracle(img, sharp), atol=2e-6)


def test_cas_peak_mapping():
    """(tests/test_cas.py:53-58) CasSetup's peak, equal to JAX's."""
    assert abs(tcas.cas_peak(0.0) + 1.0 / 8.0) < 1e-9
    assert abs(tcas.cas_peak(1.0) + 1.0 / 5.0) < 1e-9
    assert abs(tcas.cas_peak(0.5) + 1.0 / 6.5) < 1e-9
    assert tcas.cas_peak(2.0) == tcas.cas_peak(1.0)
    for s in (-1.0, 0.0, 0.3, 0.8, 1.0, 3.0):
        assert tcas.cas_peak(s) == jcas.cas_peak(s)


def test_cas_flat_unchanged_and_sharpens_edge():
    """(tests/test_cas.py:61-76) A flat frame stays within 1e-6; a blurred
    ramp's interior gradient grows."""
    out = tcas.cas(torch.full((3, 16, 16), 0.4), 0.8)
    np.testing.assert_allclose(out.numpy(), 0.4, atol=1e-6)
    ramp = torch.from_numpy(np.linspace(0.2, 0.8, 32, dtype=np.float32))
    soft = tres.gaussian_blur5(ramp[None, None, :].expand(1, 32, 32).contiguous())
    sharp = tcas.cas(soft, 1.0)
    g_soft = np.abs(np.diff(soft[0].numpy(), axis=1))[8:-8, 8:-8].mean()
    g_sharp = np.abs(np.diff(sharp[0].numpy(), axis=1))[8:-8, 8:-8].mean()
    assert g_sharp > g_soft


def test_cas_differs_from_rcas():
    """(tests/test_cas.py:79-84) CAS and RCAS are different kernels."""
    tex = torch.from_numpy(np.array(fixtures.make_texture(24, 24, np.random.default_rng(42))))[None]
    assert float((tcas.cas(tex, 0.8) - trcas.rcas(tex, 0.8)).abs().max()) > 1e-3


def test_cas_filter_matches_jax():
    """(tests/test_cas.py:87-94) CASFilter against JAX's within 1e-6 and the
    oracle within 2e-6; format, timestamp and alpha pass through."""
    rng = np.random.default_rng(42)
    tex = np.array(fixtures.make_texture(16, 16, rng)).astype(np.float32)
    px = np.stack([tex, tex * 0.9, 1.0 - tex])
    alpha = rng.uniform(size=(16, 16)).astype(np.float32)
    _, oj = lj.CASFilter(jcfg.CASFilterSettings(sharpness=0.6)).step(
        (), lj.Frame.create(jnp.asarray(px), timestamp=0.5, fmt=lj.PixelFormat.YUV))
    _, ot = lt.CASFilter(tcfg.CASFilterSettings(sharpness=0.6)).step(
        (), lt.Frame.create(torch.from_numpy(px), timestamp=0.5, fmt=lt.PixelFormat.YUV,
                            alpha=torch.from_numpy(alpha)))
    np.testing.assert_allclose(ot.pixels.numpy(), np.asarray(oj.pixels), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ot.pixels.numpy(), _cas_oracle(px, 0.6), atol=2e-6)
    assert ot.format is lt.PixelFormat.YUV and float(ot.timestamp) == 0.5
    assert np.array_equal(ot.alpha.numpy(), alpha)


@pytest.mark.parametrize("shape", [(3, 24, 40), (24, 40), (4, 3, 7), (1, 1, 5), (2, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cas_op_on_cpu_is_plain(shape):
    """The custom op ``lvk::cas`` on a CPU tensor is `cas_plain`, bit for
    bit, at sharpness 0, 0.8 and 1 (rows and columns of 1 included: the
    edge-replicated neighbourhood is the pixel itself there)."""
    img = torch.from_numpy(np.random.default_rng(11).uniform(size=shape).astype(np.float32))
    for sharpness in (0.0, 0.8, 1.0):
        assert torch.equal(tcas.cas(img, sharpness), tcas.cas_plain(img, sharpness))


def _cas_streams(s=4, c=3, h=12, w=20):
    return torch.from_numpy(np.random.default_rng(12).uniform(size=(s, c, h, w)).astype(np.float32))


@pytest.mark.parametrize("axis", [0, 1])
def test_cas_vmap_one_batched_call(monkeypatch, axis):
    """torch.func.vmap of ops/cas.cas over streams, the stream axis at 0 or
    at 1, enters the batched rule ONCE with the streams first, and equals
    per-stream calls bit for bit."""
    imgs = _cas_streams()
    calls = []
    orig = tcas.cas_batched_plain

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return orig(x, *args)

    monkeypatch.setattr(tcas, "cas_batched_plain", spy)
    moved = imgs.movedim(0, axis).contiguous()
    got = torch.func.vmap(lambda im: tcas.cas(im, 0.7), in_dims=axis)(moved)
    assert calls == [tuple(imgs.shape)]
    assert torch.equal(got, torch.stack([tcas.cas(im, 0.7) for im in imgs]))


def test_cas_vmap_unbatched_operand():
    """A frame every stream shares: through vmap beside a batched operand
    (the frame unbatched, its gain per stream), and through
    ``lvk::cas_batched`` at stream stride 0; both equal the solo calls bit
    for bit."""
    img = _cas_streams(s=1)[0]
    gains = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float32)
    got = torch.func.vmap(lambda im, g: tcas.cas(im * g, 0.8), in_dims=(None, 0))(img, gains)
    assert torch.equal(got, torch.stack([tcas.cas(img * g, 0.8) for g in gains]))
    shared = torch.ops.lvk.cas_batched(img[None].expand(3, -1, -1, -1), 0.8)
    assert all(torch.equal(shared[s], tcas.cas(img, 0.8)) for s in range(3))


# ------------------------------------------------------------ conversion


@pytest.mark.parametrize("target,extract", [("YUV", None), ("BGR", None), ("GRAY", None),
                                            ("YUV", 0), ("RGB", 2)])
def test_conversion_filter_matches_jax(target, extract):
    """ConversionFilter from RGB, with and without extract_channel, against
    JAX's: pixels within 1e-6, format, channels and output_spec equal."""
    rng = np.random.default_rng(9)
    px = rng.uniform(size=(3, 12, 20)).astype(np.float32)
    fj = lj.ConversionFilter(target=_fmt(lj, target), extract_channel=extract)
    ft = lt.ConversionFilter(target=_fmt(lt, target), extract_channel=extract)
    _, oj = fj.step((), lj.Frame.create(jnp.asarray(px), fmt=lj.PixelFormat.RGB))
    _, ot = ft.step((), lt.Frame.create(torch.from_numpy(px), fmt=lt.PixelFormat.RGB))
    np.testing.assert_allclose(ot.pixels.numpy(), np.asarray(oj.pixels), atol=1e-6, rtol=0)
    assert ot.format.name == oj.format.name
    sj = fj.output_spec(lj.FrameSpec(12, 20, 3, lj.PixelFormat.RGB))
    st = ft.output_spec(lt.FrameSpec(12, 20, 3, lt.PixelFormat.RGB))
    assert (st.channels, st.format.name, st.height, st.width) == (sj.channels, sj.format.name, *sj.size)
    assert st.channels == ot.channels


def test_conversion_filter_rejects_bad_channel():
    with pytest.raises(ValueError, match="extract_channel"):
        lt.ConversionFilter(target=lt.PixelFormat.YUV, extract_channel=3).step(
            (), lt.Frame.create(torch.zeros(3, 4, 4), fmt=lt.PixelFormat.RGB))


# ------------------------------------------------ vs + adb + cas chain

SIZE = (96, 128)
N, CARRY_AT, PREDICTIVE = 12, 6, 2
# The chain's bound, that of the scaling chain (tests/test_torch_scaling.py):
# max 4/255, mean 1e-4.  The stabilizer's u8 warp lets a pixel differ by
# 1 LSB (tests/test_torch_stabilization.py) and the deblocker passes a
# difference on at gain <= 1; CAS at sharpness 0.8 (peak w = -1/5.6) could
# amplify an isolated 1 LSB step up to (1 + 4|w|) / (1 - 4|w|) = 6 times,
# but its neighbours' differences are not of opposite signs on this clip
# (2.8/255 at most, no flipped block).
CHAIN_MAX = 4.0 / 255.0
# How far a pixel of the deblocker's input reaches into the chain's output:
# a flipped keep block half a block into its neighbours, a pixel through the
# smooth frame (a 4-pixel pooling cell, the 5x5 median over cells, the x4
# bilinear upsample) about a block; CAS adds one pixel.
KEEP_REACH, SMOOTH_REACH = BLOCK // 2 + 1, BLOCK + 2


class TapJ(lj.VideoFilter):
    """An identity stage whose state is the frame passing it (JAX): put
    before the deblocker, it exposes the stabilizer's output, which the
    deblocker sees, without changing the chain's output."""

    def init(self, spec):
        return jnp.zeros((spec.channels, spec.height, spec.width), jnp.float32)

    def step(self, state, frame, *, drain=False):
        return frame.pixels, frame


class TapT(lt.VideoFilter):
    """TapJ in the port."""

    def init(self, spec, device="cuda", seed=0):
        return torch.zeros((spec.channels, spec.height, spec.width), device=device)

    def step(self, state, frame, *, drain=False):
        return frame.pixels, frame


def chain_stages(pkg, cfg, stab_settings):
    """The JAX package's `vs + adb + cas` (its multi-chip dry run's chain):
    the stabilizer, a tap of the deblocker's input, the deblocker, CAS."""
    tap = TapJ() if pkg is lj else TapT()
    return (pkg.StabilizationFilter(settings=stab_settings), tap, pkg.DeblockingFilter(),
            pkg.CASFilter())


def _grow(mask, r):
    """Pixels within r (Chebyshev) of a set pixel of the (H, W) mask."""
    h, w = mask.shape
    grown = np.zeros((h + 2 * r, w + 2 * r), bool)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            grown[dy:dy + h, dx:dx + w] |= mask
    return grown[r:r + h, r:r + w]


def flipped_blocks(tap_t, tap_j):
    """Blocks whose keep differs between the packages, from each package's
    own measure of its deblocker input (YUV: luma is plane 0): the inputs
    differ where the stabilizer's u8 warp does, and where both 255 measures
    lie near one integer 1..L the floor takes them apart.  Every such block
    must lie within 0.05 of that integer on both sides."""
    _, h, w = tap_j.shape
    gray = jnp.asarray(tap_j[0, :h // BLOCK * BLOCK, :w // BLOCK * BLOCK])
    ref = jres.upsample_nearest_int(jres.avg_pool(gray, BLOCK), BLOCK)
    mj = np.asarray(jres.avg_pool(jnp.abs(gray - ref), BLOCK))
    mt = tdeblock.block_measure(torch.from_numpy(tap_t[0, :h // BLOCK * BLOCK, :w // BLOCK * BLOCK]),
                                BLOCK).numpy()
    flip = np.minimum(np.floor(mt * 255.0), LEVELS) != np.minimum(np.floor(mj * 255.0), LEVELS)
    k = np.round(mj[flip] * 255.0)
    assert (np.abs(mt[flip] * 255.0 - k) <= 0.05).all() and (np.abs(mj[flip] * 255.0 - k) <= 0.05).all()
    return flip, mj


def chain_compare(got, want, tap_t, tap_j):
    """One valid output of the chain against JAX's: the stabilizer's outputs
    (the taps) within 1 LSB but on at most 0.1% of pixels (the u8 warp's
    bound); the output's mean within 1e-4 away from the flipped keep blocks
    (`flipped_blocks`), and its max within CHAIN_MAX away from them and from
    the taps' pixels more than 1 LSB apart.  Returns (flipped blocks, pixels
    held to the max, pixels, the JAX measure)."""
    _, h, w = got.shape
    tap_d = np.abs(tap_t - tap_j).max(0) * 255.0
    assert (tap_d > 1.0 + 1e-3).mean() <= 1e-3, (tap_d > 1.0 + 1e-3).sum()
    flip, mj = flipped_blocks(tap_t, tap_j)
    near_flip = _grow(np.kron(flip, np.ones((BLOCK, BLOCK), bool)).astype(bool)[:h, :w], KEEP_REACH)
    d = np.abs(got - want)
    assert d[:, ~near_flip].mean() <= 1e-4, d[:, ~near_flip].mean()
    held = ~(near_flip | _grow(tap_d > 1.0 + 1e-3, SMOOTH_REACH))
    assert d[:, held].max() <= CHAIN_MAX, d[:, held].max()
    return int(flip.sum()), int(held.sum()), h * w, mj


def _stab_settings(cfg):
    """The flagship settings cut to size, as tests/test_torch_scaling.py
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
def chain_runs():
    """The chain of both packages over the same shaky YUV clip on the u8
    grid, as decoded video is (one jit of the JAX step), the JAX state after
    CARRY_AT frames, and the port's next output from that state."""
    rng = np.random.default_rng(0)
    base = np.array(fixtures.make_texture(220, 260, rng))
    base[70:130, 100:170] = 0.6  # a flat patch in view: blocks the deblocker smooths
    poses, _ = fixtures.shaky_path(N, rng, margin=50.0, drift_px=0.5, shake_px=2.5)
    clip = []
    for p in poses:
        y = np.round(np.array(fixtures.render_frame(base, p, SIZE), np.float32) * 255.0) / 255.0
        clip.append(np.stack([y, np.full_like(y, 0.5), np.full_like(y, 0.5)]).astype(np.float32))
    cj = lj.CompositeFilter(chain_stages(lj, jcfg, _stab_settings(jcfg)))
    ct = lt.CompositeFilter(chain_stages(lt, tcfg, _stab_settings(tcfg)))
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
        jout.append((bool(oj.valid), np.asarray(oj.pixels), np.asarray(sj[1])))
        tout.append((bool(ot.valid), ot.pixels.numpy(), st[1].numpy()))
    # The carried state: the stages' states without the tap's, which the
    # port's chain of the real stages takes.
    filters = tuple(f for f in ct.filters if not isinstance(f, TapT))
    state = interop.composite_state_from_numpy(carried[:1] + carried[2:], filters, "cpu")
    assert state[1:] == ((), ())
    state = (state[0], torch.zeros(3, *SIZE), *state[1:])
    state, out = ct.step(state, lt.Frame.create(torch.from_numpy(clip[CARRY_AT]), timestamp=CARRY_AT / 30.0,
                                                fmt=lt.PixelFormat.YUV))
    return dict(jax=jout, torch=tout, carried=(bool(out.valid), out.pixels.numpy(), state[1].numpy()))


def test_chain_matches_jax(chain_runs):
    """vs + adb + cas: valid flags frame for frame and every valid (3, 96,
    128) output within `chain_compare`'s bounds of JAX's, the max held on
    at least 60% of the pixels; the deblocker smooths some blocks."""
    vj = [v for v, _, _ in chain_runs["jax"]]
    assert [v for v, _, _ in chain_runs["torch"]] == vj == [t >= PREDICTIVE for t in range(N)]
    flips = smoothed = held = total = 0
    for (vj, pj, tj), (_, pt, tt) in zip(chain_runs["jax"], chain_runs["torch"]):
        assert pt.shape == pj.shape == (3, *SIZE)
        if vj:
            f, n_held, n, mj = chain_compare(pt, pj, tt, tj)
            flips, held, total = flips + f, held + n_held, total + n
            smoothed += int((mj * 255.0 < LEVELS).sum())
    assert smoothed > 0 and held >= 0.6 * total
    print(f"vs + adb + cas: {flips} keep blocks flipped, {smoothed} smoothed, in {N - PREDICTIVE} "
          f"frames of {SIZE[0] // BLOCK * (SIZE[1] // BLOCK)} blocks; max held on {held / total:.3f}")


def test_chain_state_carried_from_jax(chain_runs):
    """One port step from the JAX chain's state after CARRY_AT frames (the
    deblocker's and CAS's states are ()) gives JAX's next output within
    `chain_compare`'s bounds."""
    valid, px, tt = chain_runs["carried"]
    vj, pj, tj = chain_runs["jax"][CARRY_AT]
    assert valid == vj
    chain_compare(px, pj, tt, tj)
