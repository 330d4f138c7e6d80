"""Camera calibration + undistortion fields (counterpart of
livevisionkit_tpu/vision/calibration.py).

Reference parity: ``lvk::CameraCalibrator`` (reference Vision/
CameraCalibrator.cpp): chessboard corners fed per frame (:49-67),
cv::calibrateCamera -> CameraParameters {3x3 matrix, 5 distortion coeffs}
(:85-112); and the undistort-map construction of the lens-correction filter
(reference Modules/OBS-Plugin/Sources/Enhancement/LCFilter.cpp:133-171:
getOptimalNewCameraMatrix + initUndistortRectifyMap converted into a
normalized WarpField with view-region crop).

Calibration is an OFFLINE tool, so the solver runs in host numpy (Zhang's
method: homography-based intrinsic init + Levenberg-Marquardt refinement),
the JAX package's own code kept here as the port's copy.  The *runtime*
product is `undistort_field`: a WarpField on the device encoding the
inverse rectification map, applied per frame by the lens-correction
filter through the warp kernel.  The field is computed in host float64
exactly as the JAX package computes it, then uploaded once.

The distortion model matches OpenCV's 5-coefficient model
(k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from livevisionkit_tpu_torch.models.warp_field import WarpField


@dataclass(frozen=True)
class CameraParameters:
    """Pinhole intrinsics + OpenCV distortion (reference CameraCalibrator
    .hpp:27-31; persisted as fx,fy,cx,cy,k1,k2,p1,p2,k3 like the reference's
    calib-profiles.ini, CCTool.cpp:120-177)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )

    @property
    def distortion(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float64)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CameraParameters":
        return cls(**{k: float(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# distortion model
# ---------------------------------------------------------------------------


def distort_normalized(xn, yn, p: CameraParameters):
    """Apply the OpenCV distortion model to normalized camera coords.
    Works for numpy arrays and torch tensors alike."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3))
    xd = xn * radial + 2.0 * p.p1 * xn * yn + p.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p.p1 * (r2 + 2.0 * yn * yn) + 2.0 * p.p2 * xn * yn
    return xd, yd


def optimal_new_camera(
    p: CameraParameters, size: tuple[int, int], alpha: float = 0.0
) -> CameraParameters:
    """Free-scaling rectified intrinsics (cv::getOptimalNewCameraMatrix
    analogue, used by LCFilter.cpp:139-147).  alpha=0 -> zoom so only valid
    pixels remain; alpha=1 -> keep every source pixel."""
    h, w = size
    # Trace the border of the distorted image into undistorted normalized
    # coords by inverting the distortion numerically per border sample.
    ts = np.linspace(0, 1, 65)
    border = np.concatenate(
        [
            np.stack([ts * (w - 1), np.zeros_like(ts)], -1),
            np.stack([ts * (w - 1), np.full_like(ts, h - 1)], -1),
            np.stack([np.zeros_like(ts), ts * (h - 1)], -1),
            np.stack([np.full_like(ts, w - 1), ts * (h - 1)], -1),
        ]
    )
    xn = (border[:, 0] - p.cx) / p.fx
    yn = (border[:, 1] - p.cy) / p.fy
    # Invert distortion by fixed-point iteration (OpenCV undistortPoints).
    xu, yu = xn.copy(), yn.copy()
    for _ in range(10):
        xd, yd = distort_normalized(xu, yu, p)
        xu += xn - xd
        yu += yn - yd

    # Outer rect: bounding box of all undistorted border points.
    ox0, ox1 = xu.min(), xu.max()
    oy0, oy1 = yu.min(), yu.max()
    # Inner rect: the largest axis box inside the undistorted border —
    # approximated per side like OpenCV (extrema of each border edge).
    n = len(ts)
    top, bottom = slice(0, n), slice(n, 2 * n)
    left, right = slice(2 * n, 3 * n), slice(3 * n, 4 * n)
    ix0 = xu[left].max()
    ix1 = xu[right].min()
    iy0 = yu[top].max()
    iy1 = yu[bottom].min()

    def k_for(x0, x1, y0, y1):
        fx = (w - 1) / (x1 - x0)
        fy = (h - 1) / (y1 - y0)
        return fx, fy, -x0 * fx, -y0 * fy

    fin = k_for(ix0, ix1, iy0, iy1)
    fout = k_for(ox0, ox1, oy0, oy1)
    mix = tuple(a * (1 - alpha) + b * alpha for a, b in zip(fin, fout))
    return CameraParameters(fx=mix[0], fy=mix[1], cx=mix[2], cy=mix[3])


def undistort_field(
    p: CameraParameters,
    size: tuple[int, int],
    field_shape: tuple[int, int] = (33, 33),
    alpha: float = 0.0,
    device: torch.device | str = "cuda",
) -> WarpField:
    """Rectification warp as a normalized WarpField on `device`
    (LCFilter.cpp:133-171).

    For each control point u of the rectified output, the field stores the
    backward offset to its distorted source pixel (initUndistortRectifyMap
    semantics), so `field.apply(frame)` undistorts.  On a CUDA device the
    offsets go up from pinned memory by a non-blocking copy, so building
    the field inside a stream's first step waits for nothing.
    """
    h, w = size
    new_k = optimal_new_camera(p, size, alpha)
    hm, wm = field_shape
    yy = np.linspace(0, h - 1, hm)
    xx = np.linspace(0, w - 1, wm)
    gx, gy = np.meshgrid(xx, yy)
    xn = (gx - new_k.cx) / new_k.fx
    yn = (gy - new_k.cy) / new_k.fy
    xd, yd = distort_normalized(xn, yn, p)
    sx = xd * p.fx + p.cx
    sy = yd * p.fy + p.cy
    off = np.stack([(sy - gy) / (h - 1), (sx - gx) / (w - 1)]).astype(np.float32)
    host = torch.from_numpy(off)
    device = torch.device(device)
    if device.type == "cuda":
        return WarpField(offsets=host.pin_memory().to(device, non_blocking=True))
    return WarpField(offsets=host.to(device))


# ---------------------------------------------------------------------------
# Zhang calibration (host-side, offline)
# ---------------------------------------------------------------------------


def _homography_dlt(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography (numpy, float64)."""

    def norm_t(pts):
        m = pts.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - m, axis=1)), 1e-12)
        return np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1]])

    ts, td = norm_t(obj_xy), norm_t(img_xy)
    o = (np.c_[obj_xy, np.ones(len(obj_xy))] @ ts.T)[:, :2]
    d = (np.c_[img_xy, np.ones(len(img_xy))] @ td.T)[:, :2]
    a = []
    for (x, y), (u, v) in zip(o, d):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(a))
    hh = vt[-1].reshape(3, 3)
    hh = np.linalg.inv(td) @ hh @ ts
    return hh / hh[2, 2]


def _intrinsics_from_homographies(hs: list[np.ndarray], size) -> np.ndarray:
    """Zhang's closed-form intrinsic init from >= 3 planar homographies."""

    def v_ij(hm, i, j):
        return np.array(
            [
                hm[0, i] * hm[0, j],
                hm[0, i] * hm[1, j] + hm[1, i] * hm[0, j],
                hm[1, i] * hm[1, j],
                hm[2, i] * hm[0, j] + hm[0, i] * hm[2, j],
                hm[2, i] * hm[1, j] + hm[1, i] * hm[2, j],
                hm[2, i] * hm[2, j],
            ]
        )

    v = []
    for hm in hs:
        v.append(v_ij(hm, 0, 1))
        v.append(v_ij(hm, 0, 0) - v_ij(hm, 1, 1))
    _, _, vt = np.linalg.svd(np.asarray(v))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    den = b11 * b22 - b12 * b12
    cy = (b12 * b13 - b11 * b23) / den
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / den))
    cx = -b13 * fx * fx / lam
    if not np.isfinite([fx, fy, cx, cy]).all() or fx <= 0 or fy <= 0:
        # Fallback init: principal point at centre, focal ~ image width.
        h, w = size
        return np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float64)
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def _pose_from_homography(k: np.ndarray, hm: np.ndarray):
    a = np.linalg.inv(k) @ hm
    lam = 1.0 / max(np.linalg.norm(a[:, 0]), 1e-12)
    r1 = a[:, 0] * lam
    r2 = a[:, 1] * lam
    t = a[:, 2] * lam
    r3 = np.cross(r1, r2)
    r = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(r)
    return u @ vt, t


def _project(params: np.ndarray, obj: np.ndarray, rvec, tvec):
    """Project planar object points with intrinsics+distortion `params` =
    [fx, fy, cx, cy, k1, k2, p1, p2, k3] and pose (Rodrigues rvec, tvec)."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        r = np.eye(3)
    else:
        k_ = rvec / theta
        kx = np.array(
            [[0, -k_[2], k_[1]], [k_[2], 0, -k_[0]], [-k_[1], k_[0], 0]]
        )
        r = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)
    pc = obj @ r.T + tvec
    xn = pc[:, 0] / pc[:, 2]
    yn = pc[:, 1] / pc[:, 2]
    p = CameraParameters(*params)
    xd, yd = distort_normalized(xn, yn, p)
    return np.stack([xd * p.fx + p.cx, yd * p.fy + p.cy], -1)


def calibrate(
    object_points: list[np.ndarray],
    image_points: list[np.ndarray],
    size: tuple[int, int],
    iterations: int = 30,
) -> tuple[CameraParameters, float]:
    """Full calibration from planar (chessboard) views.

    object_points: per view (N, 2) board coords (z=0 plane, e.g. square
    units); image_points: per view (N, 2) detected pixel corners.
    Returns (CameraParameters, RMS reprojection error) — the equivalent of
    cv::calibrateCamera (reference CameraCalibrator.cpp:85-112).
    """
    hs = [
        _homography_dlt(o.astype(np.float64), i.astype(np.float64))
        for o, i in zip(object_points, image_points)
    ]
    k = _intrinsics_from_homographies(hs, size)
    poses = [_pose_from_homography(k, hm) for hm in hs]

    def rodrigues_vec(r):
        theta = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
        if theta < 1e-12:
            return np.zeros(3)
        return (
            theta
            / (2 * np.sin(theta))
            * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        )

    # Parameter vector: intrinsics(9) + per-view pose (6 each).
    x = np.concatenate(
        [np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2], 0, 0, 0, 0, 0])]
        + [np.concatenate([rodrigues_vec(r), t]) for r, t in poses]
    )
    n_views = len(object_points)
    objs = [np.c_[o, np.zeros(len(o))].astype(np.float64) for o in object_points]
    imgs = [i.astype(np.float64) for i in image_points]

    def residuals(x):
        res = []
        for v in range(n_views):
            rv = x[9 + 6 * v : 12 + 6 * v]
            tv = x[12 + 6 * v : 15 + 6 * v]
            proj = _project(x[:9], objs[v], rv, tv)
            res.append((proj - imgs[v]).ravel())
        return np.concatenate(res)

    # Levenberg-Marquardt with numeric Jacobian (problem is small: ~9+6V
    # params, V ~ 10-30 views).
    lam = 1e-3
    r = residuals(x)
    cost = r @ r
    for _ in range(iterations):
        jac = np.empty((len(r), len(x)))
        for j in range(len(x)):
            eps = max(1e-6, 1e-6 * abs(x[j]))
            xp = x.copy()
            xp[j] += eps
            jac[:, j] = (residuals(xp) - r) / eps
        a = jac.T @ jac
        g = jac.T @ r
        for _ in range(10):
            try:
                dx = np.linalg.solve(a + lam * np.diag(np.diag(a) + 1e-12), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            x_new = x + dx
            r_new = residuals(x_new)
            c_new = r_new @ r_new
            if c_new < cost:
                x, r, cost = x_new, r_new, c_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
        else:
            break
    rms = float(np.sqrt(cost / len(r)))
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = x[:9]
    return CameraParameters(fx, fy, cx, cy, k1, k2, p1, p2, k3), rms
