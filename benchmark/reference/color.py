"""BGR <-> YUV on planar (..., 3, H, W) tensors: BT.601 full range as the
reference converts (Data/VideoFrame.cpp:170-306), Y = 0.299 R + 0.587 G +
0.114 B, U = 0.492 (B - Y) + 0.5, V = 0.877 (R - Y) + 0.5, with the
matrix and its inverse rounded to float32."""

from __future__ import annotations

import numpy as np
import torch

_R, _G, _B = 0.299, 0.587, 0.114
_FWD = np.array([[_R, _G, _B],
                 [-0.492 * _R, -0.492 * _G, 0.492 * (1.0 - _B)],
                 [0.877 * (1.0 - _R), -0.877 * _G, -0.877 * _B]], np.float32)
_OFF = np.array([0.0, 0.5, 0.5], np.float32)
_INV = np.linalg.inv(_FWD).astype(np.float32)
_INV_OFF = -_INV @ _OFF


def _apply(m: np.ndarray, off: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    p = x.unbind(-3)
    return torch.stack([float(r[0]) * p[0] + float(r[1]) * p[1] + float(r[2]) * p[2] + float(o)
                        for r, o in zip(m, off)], dim=-3)


def bgr_to_yuv(bgr: torch.Tensor) -> torch.Tensor:
    return _apply(_FWD, _OFF, bgr.flip(-3))


def yuv_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    return _apply(_INV, _INV_OFF, yuv).flip(-3)
