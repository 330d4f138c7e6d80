"""The port's CUDA kernels against their plain PyTorch versions.

The `cuda` tests need a card and skip without one (a CUDA kernel has no CPU
mode).  This file imports torch only, so on a machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The other tests check, on any machine, that a wrapper never takes its
plain version for a CPU tensor: it raises instead.
"""

import math

import numpy as np
import pytest
import torch

from livevisionkit_tpu_torch.config import FeatureDetectorSettings, OpticalFlowSettings
from livevisionkit_tpu_torch.models.homography import Homography
from livevisionkit_tpu_torch.ops import easu as easu_ops
from livevisionkit_tpu_torch.ops import rcas as rcas_ops
from livevisionkit_tpu_torch.ops import remap as remap_ops
from livevisionkit_tpu_torch.ops.cuda_kernels import easu_scale as easu_scale_kernel
from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
from livevisionkit_tpu_torch.ops.cuda_kernels import rcas as rcas_kernel
from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
from livevisionkit_tpu_torch.parallel import spatial
from livevisionkit_tpu_torch.parallel.streams import Mesh
from livevisionkit_tpu_torch.types import PixelFormat
from livevisionkit_tpu_torch.vision import features, optical_flow


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _similarity(scale, angle, tx, ty, dev):
    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    return Homography.from_similarity(f(scale), f(angle), f(tx), f(ty))


def _image(dev, size=(120, 160)):
    rng = np.random.default_rng(3)
    img = rng.uniform(0.2, 0.8, size=(3,) + size).astype(np.float32)
    img[:, 30:60, 40:90] = 0.95
    img[0, 70:90, 20:140] = 0.05
    return torch.from_numpy(img).to(dev)


def test_wrappers_reject_cpu_tensors():
    img = torch.zeros((3, 8, 8))
    smap = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel.warp(img, smap)
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel.warp_batched(img[None], smap[None])
    lv = (torch.zeros((8, 8)),)
    pts = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        lk_kernel.lk_track(lv, lv, pts, pts, 11, 5, 1.5e-9)
    with pytest.raises(ValueError, match="CUDA"):
        lk_kernel.lk_track((lv[0][None],), (lv[0][None],), pts[None], pts[None], 11, 5, 1.5e-9)
    plan = easu_ops.scale_plan((8, 8), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        easu_scale_kernel.easu_scale(img, (16, 16), plan)
    with pytest.raises(ValueError, match="CUDA"):
        rcas_kernel.rcas(img)
    # The scale and RCAS kernels take f32 only.
    for dtype in (torch.uint8, torch.float16):
        with pytest.raises(TypeError, match="f32"):
            easu_scale_kernel.easu_scale(img.to(dtype), (16, 16), plan)
        with pytest.raises(TypeError, match="f32"):
            rcas_kernel.rcas(img.to(dtype))


def test_batched_scale_wrappers_reject_cpu_tensors():
    """The stream-axis wrappers of K5 and K6 raise on a CPU stack, and on an
    f16 one, instead of taking their plain versions."""
    imgs = torch.zeros((2, 3, 8, 8))
    plan = easu_ops.scale_plan((8, 8), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        easu_scale_kernel.easu_scale_batched(imgs, (16, 16), plan)
    with pytest.raises(ValueError, match="CUDA"):
        rcas_kernel.rcas_batched(imgs)
    with pytest.raises(TypeError, match="f32"):
        easu_scale_kernel.easu_scale_batched(imgs.half(), (16, 16), plan)
    with pytest.raises(TypeError, match="f32"):
        rcas_kernel.rcas_batched(imgs.half())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_kernel_matches_plain(cuda, mode, dtype):
    """f32: atol 1e-4 (rsqrt, order of sums); u8: at most 1 LSB apart on
    at most 0.1% of pixels.  The map's corner leaves the frame."""
    img = _image(cuda)
    if dtype == "uint8":
        img = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.03, 0.03, 3.2, -2.7, cuda).sample_map(img.shape[-2:]).contiguous()
    got = warp_kernel.warp(img, smap, fill=0.0, filter_mode=mode)
    want = remap_ops.remap_plain(img, smap, fill=0.0, filter_mode=mode)
    torch.cuda.synchronize()
    if dtype == "uint8":
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_lk_kernel_matches_plain(cuda):
    """Flow within 1e-3 px on features both mark tracked; masks agree on
    >= 99% of the valid features."""
    rng = np.random.default_rng(4)
    tex = torch.from_numpy(rng.uniform(0.2, 0.5, size=(200, 260)).astype(np.float32)).to(cuda)
    for _ in range(40):
        y, x = rng.integers(0, 180), rng.integers(0, 240)
        tex[y:y + 10, x:x + 10] = float(rng.choice([0.05, 0.95]))
    size = (96, 128)
    f0 = remap_ops.remap_plain(tex, _similarity(1.0, 0.0, 40.0, 40.0, cuda).sample_map(size, inverse=False))
    f1 = remap_ops.remap_plain(
        tex, _similarity(1.0, math.radians(0.5), 42.0, 39.0, cuda).sample_map(size, inverse=False))
    det = FeatureDetectorSettings(grid_shape=(8, 8), fast_threshold_init=0.06)
    feats, _ = features.detect(f0, features.initial_thresholds(det, cuda), det)
    s = OpticalFlowSettings()
    p0, p1 = optical_flow.Pyramid.build(f0, 3), optical_flow.Pyramid.build(f1, 3)
    pts = feats.points.contiguous()
    kflow, kgood = lk_kernel.lk_track(p0.levels, p1.levels, pts, torch.zeros_like(pts),
                                      s.window_size, s.iterations, s.min_eigen_threshold)
    pflow, pgood = optical_flow.track_plain(p0, p1, pts, s)
    torch.cuda.synchronize()
    both = kgood & pgood & feats.valid
    assert int(both.sum()) >= 10
    assert float((kflow - pflow)[both].abs().max()) <= 1e-3
    assert float((kgood == pgood)[feats.valid].float().mean()) >= 0.99


def _stream_images(dev):
    """Three distinct (3, 120, 160) frames, stacked."""
    img = _image(dev)
    return torch.stack([img, img.flip(-1), img.flip(-2)]).contiguous()


def _stream_maps(dev, size):
    """One stabilization-scale similarity per stream, corners leaving the frame."""
    sims = [(1.03, 0.03, 3.2, -2.7), (0.98, -0.02, -4.0, 5.5), (1.0, 0.01, 12.0, 1.0)]
    return torch.stack([_similarity(*p, dev).sample_map(size) for p in sims])


@pytest.mark.cuda
@pytest.mark.parametrize("shared_map", [False, True])
@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_batched_matches_plain_and_solo(cuda, mode, dtype, shared_map):
    """K2 at S = 3: within K1's bounds of the plain batched version (f32
    atol 1e-4; u8 at most 1 LSB on at most 0.1% of pixels) and bit-equal
    to three solo launches.  A map shared by every stream goes in at stream
    stride 0.  torch.func.vmap of ops/remap.remap launches it once and the
    solo kernel never."""
    imgs = _stream_images(cuda)
    if dtype == "uint8":
        imgs = torch.clamp(imgs * 255.0 + 0.5, 0, 255).to(torch.uint8)
    maps = _stream_maps(cuda, imgs.shape[-2:])
    if shared_map:
        maps = maps[:1].expand(3, -1, -1, -1)
    before = warp_kernel.warp_batched.launches
    got = warp_kernel.warp_batched(imgs, maps, fill=0.0, filter_mode=mode)
    assert warp_kernel.warp_batched.launches == before + 1
    want = remap_ops.remap_batched_plain(imgs, maps, fill=0.0, filter_mode=mode)
    solo = torch.stack([warp_kernel.warp(imgs[s], maps[s], fill=0.0, filter_mode=mode)
                        for s in range(3)])
    solo_before, before = warp_kernel.warp.launches, warp_kernel.warp_batched.launches
    via_vmap = torch.func.vmap(lambda im, sm: remap_ops.remap(im, sm, fill=0.0, filter_mode=mode))(
        imgs, maps)
    assert warp_kernel.warp_batched.launches == before + 1
    assert warp_kernel.warp.launches == solo_before
    torch.cuda.synchronize()
    assert torch.equal(got, solo) and torch.equal(got, via_vmap)
    if dtype == "uint8":
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_lk_kernel_stream_axis(cuda):
    """K3 over S = 3 streams in one launch: per stream, flow within 1e-3 px
    of the plain version under vmap on features both mark tracked, masks
    agreeing on >= 99% of valid features, and bit-equal to solo launches."""
    rng = np.random.default_rng(6)
    size = (96, 128)
    det = FeatureDetectorSettings(grid_shape=(8, 8), fast_threshold_init=0.06)
    s = OpticalFlowSettings()
    p0s, p1s, pts, valid = [], [], [], []
    for k in range(3):
        tex = torch.from_numpy(rng.uniform(0.2, 0.5, size=(200, 260)).astype(np.float32)).to(cuda)
        for _ in range(40):
            y, x = rng.integers(0, 180), rng.integers(0, 240)
            tex[y:y + 10, x:x + 10] = float(rng.choice([0.05, 0.95]))
        f0 = remap_ops.remap_plain(tex, _similarity(1.0, 0.0, 40.0, 40.0, cuda).sample_map(size, inverse=False))
        f1 = remap_ops.remap_plain(tex, _similarity(
            1.0, math.radians(0.5 * k), 41.0 + k, 39.0, cuda).sample_map(size, inverse=False))
        feats, _ = features.detect(f0, features.initial_thresholds(det, cuda), det)
        p0s.append(optical_flow.Pyramid.build(f0, 3).levels)
        p1s.append(optical_flow.Pyramid.build(f1, 3).levels)
        pts.append(feats.points)
        valid.append(feats.valid)
    prev = [torch.stack(lv) for lv in zip(*p0s)]
    nxt = [torch.stack(lv) for lv in zip(*p1s)]
    pts = torch.stack(pts)
    zero = torch.zeros_like(pts)
    args = (s.window_size, s.iterations, s.min_eigen_threshold)
    before = lk_kernel.lk_track.launches
    kflow, kgood = lk_kernel.lk_track(prev, nxt, pts, zero, *args)
    assert lk_kernel.lk_track.launches == before + 1
    pflow, pgood = optical_flow.track_batched_plain(prev, nxt, pts, s)
    torch.cuda.synchronize()
    for k in range(3):
        sflow, sgood = lk_kernel.lk_track(p0s[k], p1s[k], pts[k].contiguous(), zero[k], *args)
        assert torch.equal(sflow, kflow[k]) and torch.equal(sgood, kgood[k])
        both = kgood[k] & pgood[k] & valid[k]
        assert int(both.sum()) >= 10
        assert float((kflow[k] - pflow[k])[both].abs().max()) <= 1e-3
        assert float((kgood[k] == pgood[k])[valid[k]].float().mean()) >= 0.99


def _affine_map(size, out_size, scale, angle):
    """(2, H', W') map taking output pixel u to scale * R(angle) (u - c') + c
    (c, c' the centres): scale 2 is a 0.5x zoom-out."""
    (h, w), (oh, ow) = size, out_size
    yy, xx = torch.meshgrid(torch.arange(oh, dtype=torch.float64) - (oh - 1) / 2,
                            torch.arange(ow, dtype=torch.float64) - (ow - 1) / 2, indexing="ij")
    co, si = math.cos(angle) * scale, math.sin(angle) * scale
    return torch.stack([si * xx + co * yy + (h - 1) / 2, co * xx - si * yy + (w - 1) / 2]).float()


# Channel counts and luma rules of the EASU warp: GRAY (one plane), YUV
# (luma = plane 0, with and without a 4th plane) and RGB (luma from three,
# with and without a 4th): colour + alpha is the stabilizer's 4-plane warp.
WARP_FORMATS = [(1, "GRAY"), (3, "YUV"), (3, "RGB"), (4, "YUV"), (4, "RGB")]
# Maps over a 117 x 203 or 117 x 204 source onto a 101 x 187 output (no
# multiple of the 32 x 8 block): a stabilization warp whose blocks stage
# their source box in shared memory, and a 0.5x zoom-out and a 30-degree
# rotation whose blocks exceed the box and gather from device memory.
WARP_MAPS = {"stabilize": (1.02, math.radians(2.0)), "zoom_out": (2.0, 0.0),
             "rotate30": (1.0, math.radians(30.0))}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(WARP_MAPS))
@pytest.mark.parametrize("nc_fmt", WARP_FORMATS, ids=lambda p: f"{p[0]}{p[1]}")
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("width", [203, 204])
def test_warp_kernel_tile_paths(cuda, width, dtype, nc_fmt, kind):
    """The EASU warp's shared-memory and device-memory block paths against
    the plain version, K1's bounds, and S = 8 streams bit-equal to 8 solo
    launches (the maps spread around the kind's).  A u8 source 204 wide is
    staged by 32-bit words, one 203 wide a pixel at a time."""
    nc, fmt = nc_fmt
    size, out_size = (117, width), (101, 187)
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.uniform(0.0, 1.0, size=(8, nc) + size).astype(np.float32))
    imgs[:, :, 30:70, 50:120] = 0.9
    imgs = imgs.to(cuda)
    if dtype == "uint8":
        imgs = torch.clamp(imgs * 255.0 + 0.5, 0, 255).to(torch.uint8)
    scale, angle = WARP_MAPS[kind]
    maps = torch.stack([_affine_map(size, out_size, scale * (1 + 0.01 * s), angle + 0.01 * s)
                        for s in range(8)]).to(cuda)
    pf = getattr(PixelFormat, fmt)
    got = warp_kernel.warp_batched(imgs, maps, fill=0.0, fmt=pf)
    paths = torch.zeros(2, dtype=torch.int32, device=cuda)  # stream 0's blocks
    solo = torch.stack([warp_kernel.warp(imgs[s], maps[s], fill=0.0, fmt=pf,
                                         block_paths=paths if s == 0 else None)
                        for s in range(8)])
    used, over = paths.tolist()
    assert used > 0 and (over == 0 if kind == "stabilize" else over > 0), (used, over)
    want = remap_ops.remap_batched_plain(imgs, maps, fill=0.0, filter_mode="easu", fmt=pf)
    torch.cuda.synchronize()
    assert torch.equal(got, solo)
    if dtype == "uint8":
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["YUV", "RGB"])
@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_kernel_colour_plus_alpha(cuda, dtype, mode, fmt):
    """The stabilizer's colour + alpha gather at C = 4: K1 within its bounds
    of the plain version (f32 atol 1e-4; u8 at most 1 LSB on at most 0.1%
    of pixels); its colour planes within 1e-6 (f32) or 1 LSB on 0.1% (u8)
    of the 3-plane launch, since EASU's luma comes from the colour planes,
    never from alpha; and K2 over 8 streams bit-equal to 8 solo launches."""
    pf = getattr(PixelFormat, fmt)
    img = torch.cat([_image(cuda), _image(cuda)[1:2].flip(-1)]).contiguous()
    if dtype == "uint8":
        img = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.03, 0.03, 3.2, -2.7, cuda).sample_map(img.shape[-2:]).contiguous()
    kw = dict(fill=0.0, filter_mode=mode, fmt=pf)
    got = warp_kernel.warp(img, smap, **kw)
    want = remap_ops.remap_plain(img, smap, **kw)
    colour = warp_kernel.warp(img[:3].contiguous(), smap, **kw)
    imgs = torch.stack([torch.roll(img, 7 * s, dims=-1) for s in range(8)]).contiguous()
    maps = _stream_maps(cuda, img.shape[-2:]).repeat(3, 1, 1, 1)[:8].contiguous()
    batched = warp_kernel.warp_batched(imgs, maps, **kw)
    solo = torch.stack([warp_kernel.warp(imgs[s], maps[s], **kw) for s in range(8)])
    torch.cuda.synchronize()
    assert torch.equal(batched, solo)
    for a, b in ((got, want), (got[:3], colour)):
        if dtype == "uint8":
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        else:
            assert float((a - b).abs().max()) <= (1e-4 if b is want else 1e-6)


@pytest.mark.cuda
def test_warp_kernel_rejects_five_planes(cuda):
    """Four planes (colour + alpha) is the warp kernel's limit: K1 and K2
    raise on five instead of taking the plain version."""
    img = torch.cat([_image(cuda), _image(cuda)[:2]]).contiguous()
    smap = _similarity(1.0, 0.0, 0.0, 0.0, cuda).sample_map(img.shape[-2:]).contiguous()
    with pytest.raises(ValueError, match="channels"):
        warp_kernel.warp(img, smap)
    with pytest.raises(ValueError, match="channels"):
        warp_kernel.warp_batched(img[None], smap[None])


@pytest.mark.cuda
def test_warp_kernel_u8_unaligned_frame(cuda):
    """A u8 frame with word-sized rows whose data does not start on a word
    is staged a pixel at a time, bit-equal to the same frame staged by
    words."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, size=(3, 117, 204), dtype=np.uint8)).to(cuda)
    shifted = torch.empty(img.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(img.shape)
    shifted.copy_(img)
    smap = _affine_map((117, 204), (101, 187), 1.02, math.radians(2.0)).to(cuda)
    paths = torch.zeros(2, dtype=torch.int32, device=cuda)
    got = warp_kernel.warp(shifted, smap, block_paths=paths)
    assert paths.tolist()[0] > 0 and paths.tolist()[1] == 0
    assert torch.equal(got, warp_kernel.warp(img, smap))


# (input (H, W), output (H, W)): 2x, 3/2, 4/3 and fallback ratios on odd
# sizes that are no multiple of the 64x16 tile, a downscale and a 0.5x
# downscale (whose tiles gather from device memory), a 4K-wide 1:2 row, and
# tiny frames.
SCALE_CASES = [
    ((45, 67), (90, 134)),
    ((50, 70), (75, 105)),
    ((48, 66), (64, 88)),
    ((37, 53), (61, 97)),
    ((41, 59), (29, 37)),
    ((96, 130), (48, 65)),
    ((8, 1920), (8, 3840)),
    ((5, 7), (10, 14)),
    ((2, 5), (4, 10)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["YUV", "RGB"])
@pytest.mark.parametrize("case", SCALE_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1][0]}x{c[1][1]}")
def test_easu_scale_kernel_matches_plain(cuda, case, fmt):
    """The scale kernel against easu_scale_plain, atol 1e-5 (fused
    multiply-adds and rsqrt in the EASU core), through the dispatch of
    ops/easu.easu_scale, for (C, H, W) and (H, W) inputs."""
    (h, w), size = case
    img = _image(cuda, (h, w))
    pf = getattr(PixelFormat, fmt)
    before = easu_scale_kernel.easu_scale.launches
    got = easu_ops.easu_scale(img, size, pf)
    assert easu_scale_kernel.easu_scale.launches == before + 1
    want = easu_ops.easu_scale_plain(img, size, pf)
    got2d = easu_ops.easu_scale(img[0].contiguous(), size, PixelFormat.GRAY)
    want2d = easu_ops.easu_scale_plain(img[0], size, PixelFormat.GRAY)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, *size) and got2d.shape == size
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got2d - want2d).abs().max()) <= 1e-5


# (C, H, W): sizes that are no multiple of the block; widths 1-7 (41 rows
# end inside a block's second 32-row band; widths that are no multiple of
# 4 take the scalar row path), a tall 1-column strip, 4 channels on the
# 16-byte path, and the chain's 4K frame.
RCAS_SHAPES = ([(3, 45, 67), (1, 33, 97), (4, 9, 40), (3, 2, 5)]
               + [(3, 41, w) for w in range(1, 8)] + [(1, 300, 1), (4, 37, 64), (3, 2160, 3840)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RCAS_SHAPES)
def test_rcas_kernel_matches_plain(cuda, shape):
    """The RCAS kernel against rcas_plain, atol 1e-6 (each operation is
    rounded as in the plain version), through the dispatch of ops/rcas.rcas,
    for (C, H, W) and (H, W); the same frame at a 4-byte offset from a
    16-byte boundary (the scalar row path) bit-equal to the aligned one."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0.0, 1.0, size=shape).astype(np.float32)).to(cuda)
    for sharpness in (0.2, 0.8, 1.0):
        got = rcas_ops.rcas(img, sharpness)
        want = rcas_ops.rcas_plain(img, sharpness)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-6
    got2d = rcas_ops.rcas(img[0].contiguous(), 0.8)
    assert float((got2d - rcas_ops.rcas_plain(img[0], 0.8)).abs().max()) <= 1e-6
    shifted = torch.empty(img.numel() + 1, device=cuda)[1:].view(shape)
    shifted.copy_(img)
    assert torch.equal(rcas_kernel.rcas(shifted, 0.8), rcas_kernel.rcas(img, 0.8))


def _wave_texture(rng, size):
    """A smooth f32 texture: plane waves of 20-50 px wavelength in random
    directions, so LK's basin spans several pixels at every point."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    tex = np.full(size, 0.5)
    for _ in range(6):
        k = 2.0 * math.pi / rng.uniform(20.0, 50.0)
        a = rng.uniform(0.0, math.pi)
        tex += 0.06 * np.sin(k * (math.cos(a) * xx + math.sin(a) * yy) + rng.uniform(0, 2 * math.pi))
    return tex.astype(np.float32)


def _lk_pair(dev, tex, motion, size=(96, 128)):
    """Frames 0 and 1 of `tex` (numpy) at `size`, frame 1 moved by the
    similarity `motion` = (angle in degrees, dx, dy)."""
    ang, dx, dy = motion
    t = torch.from_numpy(tex).to(dev)
    f0 = remap_ops.remap_plain(t, _similarity(1.0, 0.0, 40.0, 40.0, dev).sample_map(size, inverse=False))
    f1 = remap_ops.remap_plain(t, _similarity(1.0, math.radians(ang), 40.0 + dx, 40.0 + dy,
                                              dev).sample_map(size, inverse=False))
    return f0, f1


def _grid_points(dev, size, step=9, inset=4.3):
    """Points on a regular grid over the frame, sub-pixel, `inset` px in."""
    h, w = size
    ys, xs = np.meshgrid(np.arange(inset, h - 1, step), np.arange(inset, w - 1, step), indexing="ij")
    return torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)).to(dev)


def _lk_run(prev, nxt, pts, win, init=None):
    """The kernel and the plain version on the same pyramids; the kernel's
    restaged-feature count."""
    s = OpticalFlowSettings(window_size=win)
    init = torch.zeros_like(pts) if init is None else init
    count = torch.zeros(1, dtype=torch.int32, device=pts.device)
    kflow, kgood = lk_kernel.lk_track(prev, nxt, pts, init, s.window_size, s.iterations,
                                      s.min_eigen_threshold, restaged=count)
    pflow, pgood = optical_flow.track_plain(optical_flow.Pyramid(tuple(prev)),
                                            optical_flow.Pyramid(tuple(nxt)), pts, s, init)
    torch.cuda.synchronize()
    return kflow, kgood, pflow, pgood, int(count.item())


def _lk_agree(kflow, kgood, pflow, pgood, min_both=10):
    """Flow within 1e-3 px on the points both mark tracked; masks agree on
    >= 99% of the points."""
    both = kgood & pgood
    assert int(both.sum()) >= min_both, int(both.sum())
    assert float((kflow - pflow)[both].abs().max()) <= 1e-3
    assert float((kgood == pgood).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("win", [5, 11, 21, 31])
def test_lk_kernel_window_sizes(cuda, win, levels):
    """Every window-size instance of the kernel (5, 11, 21, 31 px: 1, 4,
    16 and 32 pixels a lane) and the n_levels = 1 call (K4) against the
    plain version on a smooth texture, grid points.  A K4 launch adds to
    its own count, not to K3's."""
    rng = np.random.default_rng(11)
    f0, f1 = _lk_pair(cuda, _wave_texture(rng, (200, 260)), (0.5, 2.2, -1.4))
    prev = optical_flow.Pyramid.build(f0, levels).levels
    nxt = optical_flow.Pyramid.build(f1, levels).levels
    k3, k4 = lk_kernel.lk_track.launches, lk_kernel.lk_track.launches_one_level
    _lk_agree(*_lk_run(prev, nxt, _grid_points(cuda, f0.shape), win)[:4])
    one = int(levels == 1)
    assert lk_kernel.lk_track.launches == k3 + 1 - one
    assert lk_kernel.lk_track.launches_one_level == k4 + one


@pytest.mark.cuda
def test_lk_kernel_restages_search_box(cuda):
    """A one-level 8 px motion: the iterates walk out of the staged search
    box, the kernel stages it again around them (counting those features),
    and the flow still agrees with the plain version, which gathers every
    window from the image.  A 21 px window keeps every feature's iterates
    well conditioned, so the two stay within rounding of each other."""
    rng = np.random.default_rng(12)
    f0, f1 = _lk_pair(cuda, _wave_texture(rng, (200, 260)), (0.0, 6.5, -5.0))
    pts = _grid_points(cuda, f0.shape, step=11, inset=14.5)
    kflow, kgood, pflow, pgood, restaged = _lk_run((f0,), (f1,), pts, 21)
    assert restaged > pts.shape[0] // 2, restaged
    _lk_agree(kflow, kgood, pflow, pgood)
    truth = torch.tensor([-6.5, 5.0], device=cuda)
    assert float((kflow[kgood].median(dim=0).values - truth).abs().max()) < 0.01


@pytest.mark.cuda
def test_lk_kernel_border_features(cuda):
    """Points on and next to the frame's edges, whose windows and boxes
    reach past it at every level: the box's replicate-clamped texels are
    the taps the image gives."""
    rng = np.random.default_rng(13)
    f0, f1 = _lk_pair(cuda, _wave_texture(rng, (200, 260)), (0.3, 1.6, 1.1))
    h, w = f0.shape
    edge = [0.0, 0.4, 1.5, 2.75]
    pts = [(x, y) for x in edge + [w - 1.0 - e for e in edge] for y in np.linspace(0, h - 1, 9)]
    pts += [(x, y) for y in edge + [h - 1.0 - e for e in edge] for x in np.linspace(0, w - 1, 9)]
    pts = torch.tensor(pts, dtype=torch.float32, device=cuda)
    prev = optical_flow.Pyramid.build(f0, 3).levels
    nxt = optical_flow.Pyramid.build(f1, 3).levels
    _lk_agree(*_lk_run(prev, nxt, pts, 11)[:4])


@pytest.mark.cuda
def test_lk_kernel_shared_pyramid_streams(cuda):
    """S = 3 streams over one `prev` pyramid broadcast at stream stride 0
    (as the vmap rule passes an unbatched operand), each with its own
    `next` pyramid and points: per stream within 1e-3 px of the plain
    version and bit-equal to solo launches."""
    rng = np.random.default_rng(14)
    tex = _wave_texture(rng, (200, 260))
    f0, _ = _lk_pair(cuda, tex, (0.0, 0.0, 0.0))
    nexts = [_lk_pair(cuda, tex, (0.4 * k, 1.5 - k, 0.5 * k))[1] for k in range(3)]
    p0 = optical_flow.Pyramid.build(f0, 3).levels
    p1s = [optical_flow.Pyramid.build(f, 3).levels for f in nexts]
    prev = [lv[None].expand(3, -1, -1) for lv in p0]
    nxt = [torch.stack(lv) for lv in zip(*p1s)]
    base = _grid_points(cuda, f0.shape)
    pts = torch.stack([base + 0.25 * k for k in range(3)])
    s = OpticalFlowSettings()
    args = (s.window_size, s.iterations, s.min_eigen_threshold)
    kflow, kgood = lk_kernel.lk_track(prev, nxt, pts, torch.zeros_like(pts), *args)
    for k in range(3):
        sflow, sgood = lk_kernel.lk_track(p0, p1s[k], pts[k].contiguous(),
                                          torch.zeros_like(pts[k]), *args)
        pflow, pgood = optical_flow.track_plain(optical_flow.Pyramid(p0),
                                                optical_flow.Pyramid(p1s[k]), pts[k], s)
        torch.cuda.synchronize()
        assert torch.equal(sflow, kflow[k]) and torch.equal(sgood, kgood[k])
        _lk_agree(kflow[k], kgood[k], pflow, pgood)


def _frames(dev, s, c, size, seed=8):
    """S distinct (C, H, W) f32 frames in [0, 1] with hard edges."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, size=(s, c) + size).astype(np.float32)
    img[:, :, size[0] // 4: size[0] // 2, size[1] // 3: 2 * size[1] // 3] = 0.95
    return torch.from_numpy(img).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("streams", [1, 3, 8])
def test_easu_scale_batched_matches_solo(cuda, streams, nc):
    """K5's stream axis: S frames in one launch bit-equal to S solo
    launches, within 1e-5 of the plain version under vmap, and
    torch.func.vmap of ops/easu.easu_scale launching it once (the solo
    kernel never)."""
    imgs = _frames(cuda, streams, nc, (45, 67))
    size = (90, 134)
    plan = easu_ops.scale_plan((45, 67), size)
    before = easu_scale_kernel.easu_scale_batched.launches
    got = easu_scale_kernel.easu_scale_batched(imgs, size, plan)
    solo = torch.stack([easu_scale_kernel.easu_scale(imgs[s].contiguous(), size, plan)
                        for s in range(streams)])
    solo_before = easu_scale_kernel.easu_scale.launches
    via_vmap = torch.func.vmap(lambda im: easu_ops.easu_scale(im, size))(imgs)
    assert easu_scale_kernel.easu_scale_batched.launches == before + 2
    assert easu_scale_kernel.easu_scale.launches == solo_before
    want = easu_ops.easu_scale_batched_plain(imgs, size)
    torch.cuda.synchronize()
    assert got.shape == (streams, nc, *size)
    assert torch.equal(got, solo) and torch.equal(got, via_vmap)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [3, 4])
def test_easu_scale_batched_shared_source(cuda, ndim):
    """A source every stream shares, at stream stride 0 (as the vmap rule
    broadcasts an unbatched operand), for (S, C, H, W) and (S, H, W): each
    stream's output bit-equal to the solo launch."""
    img = _frames(cuda, 1, 3, (50, 70))[0]
    if ndim == 3:
        img = img[0].contiguous()
    shared = img[None].expand(8, *img.shape)
    size = (75, 105)
    plan = easu_ops.scale_plan((50, 70), size)
    got = easu_scale_kernel.easu_scale_batched(shared, size, plan)
    solo = easu_scale_kernel.easu_scale(img, size, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(got[s], solo) for s in range(8))


# (S, C, H, W): widths 1-7 (width 4 on the 16-byte row path, the others on
# the scalar one), two 4K frames, and 4 channels over 8 streams.
RCAS_BATCHED_SHAPES = [(3, 3, 41, w) for w in range(1, 8)] + [(2, 3, 2160, 3840), (8, 4, 37, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RCAS_BATCHED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rcas_batched_matches_solo(cuda, shape):
    """K6's stream axis: S frames in one launch bit-equal to S solo launches
    and within 1e-6 of rcas_plain under vmap, through torch.func.vmap of
    ops/rcas.rcas (one launch, no solo launch); the same stack at a 4-byte
    offset, and with a stream stride that is no multiple of 4 floats (both
    on the scalar row path), bit-equal again."""
    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.uniform(0.0, 1.0, size=shape).astype(np.float32)).to(cuda)
    before, solo_before = rcas_kernel.rcas_batched.launches, rcas_kernel.rcas.launches
    got = torch.func.vmap(lambda im: rcas_ops.rcas(im, 0.8))(imgs)
    assert rcas_kernel.rcas_batched.launches == before + 1
    assert rcas_kernel.rcas.launches == solo_before
    solo = torch.stack([rcas_kernel.rcas(imgs[s], 0.8) for s in range(shape[0])])
    want = rcas_ops.rcas_batched_plain(imgs, 0.8)
    shifted = torch.empty(imgs.numel() + 1, device=cuda)[1:].view(shape)
    shifted.copy_(imgs)
    block = imgs[0].numel()
    padded = torch.empty((shape[0], block + 1), device=cuda)[:, :block].view(shape)
    padded.copy_(imgs)
    torch.cuda.synchronize()
    assert torch.equal(got, solo)
    assert float((got - want).abs().max()) <= 1e-6
    assert torch.equal(rcas_kernel.rcas_batched(shifted, 0.8), got)
    assert torch.equal(rcas_kernel.rcas_batched(padded, 0.8), got)


@pytest.mark.cuda
def test_rcas_batched_shared_frame(cuda):
    """A frame every stream shares, at stream stride 0: each output
    bit-equal to the solo launch (the 16-byte path stays on: stride 0 is a
    multiple of 4)."""
    img = _frames(cuda, 1, 3, (64, 96))[0]
    got = rcas_kernel.rcas_batched(img[None].expand(8, -1, -1, -1), 0.8)
    solo = rcas_kernel.rcas(img, 0.8)
    torch.cuda.synchronize()
    assert all(torch.equal(got[s], solo) for s in range(8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_kernel_on_mesh_map(cuda, dtype):
    """K1 on the dense (2, H, W) map of a 16x16 mesh (a homography plus a
    smooth local bulge), as mesh mode's WarpField.apply feeds it: within
    K1's bounds of the plain version (f32 atol 1e-4; u8 at most 1 LSB on
    at most 0.1% of pixels), every block on its shared-memory path, and
    `apply` launching the solo kernel once."""
    from livevisionkit_tpu_torch.models.warp_field import WarpField

    size = (272, 480)
    img = _frames(cuda, 1, 3, size)[0]
    if dtype == "uint8":
        img = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    h = _similarity(1.01, 0.01, 3.0, -2.0, cuda)
    field = WarpField.from_homography(h, (16, 16), size)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, 16, device=cuda), torch.linspace(0, 1, 16, device=cuda),
                            indexing="ij")
    bulge = 0.01 * torch.sin(math.pi * yy) * torch.sin(math.pi * xx)
    field = WarpField(offsets=field.offsets + torch.stack([bulge, -bulge]))
    smap = field.sample_map(size)
    paths = torch.zeros(2, dtype=torch.int32, device=cuda)
    got = warp_kernel.warp(img, smap, fill=0.0, block_paths=paths)
    want = remap_ops.remap_plain(img, smap, fill=0.0, filter_mode="easu")
    before = warp_kernel.warp.launches
    applied = field.apply(img, fill=0.0)
    assert warp_kernel.warp.launches == before + 1
    torch.cuda.synchronize()
    used, over = paths.tolist()
    assert used > 0 and over == 0, (used, over)
    assert torch.equal(applied, got)
    if dtype == "uint8":
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("nc", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("size", [(121, 163), (120, 160)])
def test_warp_kernel_on_undistort_map(cuda, size, dtype, nc, mode):
    """K1 on the lens-correction filter's dense map (a barrel undistortion,
    k1 = -0.25, at alpha 0.5 so the border samples leave the frame), at odd
    and even sizes, colour (C = 3) and colour + alpha (C = 4): within K1's
    bounds of the plain version (f32 atol 1e-4; u8 at most 1 LSB on at
    most 0.1% of pixels), and the filter's step is one K1 launch."""
    from livevisionkit_tpu_torch.filters.lens_correction import LensCorrectionFilter
    from livevisionkit_tpu_torch.data.frame import Frame
    from livevisionkit_tpu_torch.filters.base import FrameSpec
    from livevisionkit_tpu_torch.vision.calibration import CameraParameters, undistort_field

    h, w = size
    params = CameraParameters(fx=0.9 * w, fy=0.9 * w, cx=(w - 1) / 2 + 1.5, cy=(h - 1) / 2 - 2.0,
                              k1=-0.25, k2=0.05)
    field = undistort_field(params, size, alpha=0.5, device=cuda)
    smap = field.sample_map(size).contiguous()
    out = (smap[0] < 0) | (smap[0] > h - 1) | (smap[1] < 0) | (smap[1] > w - 1)
    assert int(out.sum()) > 0
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0.0, 1.0, size=(nc, h, w)).astype(np.float32))
    img[:, 30:70, 50:120] = 0.9
    img = img.to(cuda)
    if dtype == "uint8":
        img = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    got = warp_kernel.warp(img, smap, fill=0.0, filter_mode=mode)
    want = remap_ops.remap_plain(img, smap, fill=0.0, filter_mode=mode)
    torch.cuda.synchronize()
    if dtype == "uint8":
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert float((got - want).abs().max()) <= 1e-4
    if dtype == "float32":
        filt = LensCorrectionFilter(parameters=params, alpha=0.5, warp_filter=mode)
        alpha = nc == 4
        state = filt.init(FrameSpec(h, w, 3, PixelFormat.YUV, has_alpha=alpha), device=cuda)
        frame = Frame.create(img[:3], fmt=PixelFormat.YUV, alpha=img[3] if alpha else None)
        before = warp_kernel.warp.launches
        _, res = filt.step(state, frame)
        assert warp_kernel.warp.launches == before + 1
        step_px = torch.cat([res.pixels, res.alpha[None]]) if alpha else res.pixels
        assert torch.equal(step_px, got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["easu", "bilinear"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_tiled_matches_solo(cuda, mode, dtype):
    """`remap_sharded` over four tiles of one card launches K1 once a tile
    on a halo-padded source wider than its output, and matches K1's solo
    launch on the whole frame (f32 within 1e-5, u8 within 1 LSB) and the
    same tiles on the CPU (the plain version) alike."""
    size = (120, 320)
    img = _image(cuda, size)
    if dtype == "uint8":
        img = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
    smap = _similarity(1.001, 0.002, 5.0, -3.0, cuda).sample_map(size).contiguous()
    kw = dict(fill=0.0, halo=48, filter_mode=mode)
    before = warp_kernel.warp.launches
    got = spatial.remap_sharded(img, smap, Mesh([cuda] * 4, ("tile",)), **kw)
    assert warp_kernel.warp.launches - before == 4
    assert got.device == cuda and got.shape == img.shape and got.dtype == img.dtype
    solo = warp_kernel.warp(img, smap, fill=0.0, filter_mode=mode)
    plain = spatial.remap_sharded(img.cpu(), smap.cpu(), Mesh(["cpu"] * 4, ("tile",)), **kw)
    for want in (solo.cpu(), plain):
        if dtype == "uint8":
            assert int((got.cpu().int() - want.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_warp_tiled_rejects_uneven_tiles(cuda):
    img = _image(cuda, (120, 320))
    smap = _similarity(1.0, 0.0, 0.0, 0.0, cuda).sample_map((120, 320)).contiguous()
    with pytest.raises(ValueError, match="must divide"):
        spatial.remap_sharded(img, smap, Mesh([cuda] * 3, ("tile",)))


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(cuda):
    """With cuda:0 current, each kernel given tensors on cuda:1 (a tile or a
    stream group of a multi-card mesh) runs on cuda:1 and gives, bit for
    bit, what it gives on cuda:0; `remap_sharded` over tiles alternating
    between the two cards is solo K1's warp."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0

    def same(fn, *args):
        here = fn(*args)
        there = fn(*[a.to(other) for a in args])
        torch.cuda.synchronize(other)
        for a, b in zip(here if isinstance(here, tuple) else (here,),
                        there if isinstance(there, tuple) else (there,)):
            assert b.device == other and torch.equal(a, b.to(cuda))

    img = _image(cuda)
    smap = _similarity(1.03, 0.03, 3.2, -2.7, cuda).sample_map(img.shape[-2:]).contiguous()
    same(lambda i, m: warp_kernel.warp(i, m, fill=0.0), img, smap)
    same(lambda i, m: warp_kernel.warp_batched(i, m), img[None], smap[None])
    same(lambda i: rcas_kernel.rcas(i, 0.8), img)
    same(lambda i: easu_scale_kernel.easu_scale(i, (240, 320), easu_ops.scale_plan((120, 160), (240, 320))),
         img)
    p0 = optical_flow.Pyramid.build(img[0].contiguous(), 3)
    p1 = optical_flow.Pyramid.build(img[0].roll(2, dims=1).contiguous(), 3)
    pts = torch.tensor([[40.0, 50.0], [80.0, 60.0], [120.0, 90.0]], device=cuda)
    s = OpticalFlowSettings()
    same(lambda pts, *lv: lk_kernel.lk_track(lv[:3], lv[3:], pts, torch.zeros_like(pts), s.window_size,
                                             s.iterations, s.min_eigen_threshold),
         pts, *p0.levels, *p1.levels)
    got = spatial.remap_sharded(img, smap, Mesh([cuda, other, cuda, other], ("tile",)), halo=16,
                                filter_mode="easu")
    assert got.device == cuda and torch.equal(got, warp_kernel.warp(img, smap, fill=0.0))
