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
from livevisionkit_tpu_torch.ops import remap as remap_ops
from livevisionkit_tpu_torch.ops.cuda_kernels import lk as lk_kernel
from livevisionkit_tpu_torch.ops.cuda_kernels import warp as warp_kernel
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
    lv = (torch.zeros((8, 8)),)
    pts = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        lk_kernel.lk_track(lv, lv, pts, pts, 11, 5, 1.5e-9)


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
