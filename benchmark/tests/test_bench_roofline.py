"""The frozen roofline counts give the bounds `chip_smoke.py` printed for the
same shapes: K1 EASU on 8-bit 3 x 1080 x 1920 at 0.0140 ms, K3 on the
flagship's 3-level 272 x 480 pyramids with 510 features at 0.00041 ms."""

import pytest
import torch

from tiny import BENCH  # noqa: F401

from harness import manifest, roofline
from reference.stabilizer import sample_map


def test_k1_easu_u8_1080p():
    # A small correction: every output but the border ring is EASU.
    smap = sample_map(torch.tensor([[[0.002, 0.002], [0.002, 0.002]],
                                    [[-0.001, -0.001], [-0.001, -0.001]]]), (1080, 1920),
                      torch.float32, "cpu")
    assert roofline.easu_warp_bound_ms(smap, 3, 1, 1) == pytest.approx(0.0140, abs=5e-5)


def test_k3_flagship():
    cfg = manifest.config("vs1080_homography")
    work = roofline.stabilizer_work(cfg, torch.zeros(1, 2, 4, 4), 1)["lk"]
    assert work["levels"] == [(272, 480), (136, 240), (68, 120)] and work["features"] == 510
    ms = roofline.lk_bound_ms(work["levels"], work["features"], work["window"], work["iterations"])
    assert ms == pytest.approx(0.00041, abs=5e-6)
    assert roofline.lk_bound_ms(work["levels"], 510, 11, 5, n_streams=8) == pytest.approx(8 * ms)


def test_easu_work_counts_inside_only():
    smap = sample_map(torch.zeros(2, 2, 2), (40, 60), torch.float32, "cpu")
    n_out, n_src = roofline.easu_work(smap, 40, 60)
    # EASU needs x0 in [1, w - 5] and y0 in [1, h - 5]; the corners cover one more.
    assert n_out == (40 - 5) * (60 - 5)
    assert n_src == (40 - 4) * (60 - 4)
