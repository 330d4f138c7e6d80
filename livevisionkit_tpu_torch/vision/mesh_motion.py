"""Local (mesh) motion estimation: the WarpField least-squares solve
(counterpart of livevisionkit_tpu/vision/mesh_motion.py; reference
Vision/FrameTracker.cpp:200-321, estimate_local_motions).

A sparse least-squares fit of an (Hm, Wm) mesh to the matched features:
bilinear feature constraints, first-difference rigidity constraints, a
temporal pull toward the previous frame's local mesh and a weak pull
toward the global (homography) fit.  The system is never materialized:
conjugate gradient runs on the normal equations with a matrix-free
operator,

  * feature term: bilinear sampling of the mesh at the tracked points (a
    gather, `_sample`) and its adjoint, a 4-tap scatter-add (`_scatter`,
    `index_add`);
  * rigidity term: first-difference stencils along both mesh axes and their
    adjoints;
  * temporal and global terms: diagonal.

Outliers are down-weighted by IRLS rounds with a truncated quadratic.  The
JAX package's `fori_loop` is a Python loop over the static
`cg_iterations`, and every data-dependent choice is a `torch.where`: no
early exit on the residual and no Python branch on a tensor, so the solve
never waits for the device, and it batches under `torch.func.vmap` (every
op here has a batching rule).  On the card `index_add` sums in no fixed
order, so a card solve agrees with the CPU's within rounding, not bit for
bit.  The mesh is solved in detection-frame pixels and returned
normalized.  `solve` is the same fit over features split into shards on
several devices (parallel/distributed_solve.py); `estimate` is its one
shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.config import MeshMotionSettings
from livevisionkit_tpu_torch.models.warp_field import WarpField, _to_norm, _to_px


def _bilinear_weights(pts: torch.Tensor, mesh_shape: tuple[int, int], size):
    """Mesh-cell bilinear interpolation data for (N, 2) (x, y) points:
    (idx (N, 4) flat node ids, w (N, 4) weights)."""
    hm, wm = mesh_shape
    h, w = size
    gx = torch.clamp(pts[:, 0] * ((wm - 1) / (w - 1)), 0.0, wm - 1.0001)
    gy = torch.clamp(pts[:, 1] * ((hm - 1) / (h - 1)), 0.0, hm - 1.0001)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    fx = gx - x0
    fy = gy - y0
    idx = torch.stack([y0 * wm + x0, y0 * wm + x0 + 1, (y0 + 1) * wm + x0, (y0 + 1) * wm + x0 + 1],
                      dim=-1)
    w4 = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=-1)
    return idx, w4


def _sample(mesh: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """A x: sample the (2, Hm, Wm) mesh at the features -> (N, 2) (dy, dx)."""
    vals = mesh.reshape(2, -1)[:, idx]  # (2, N, 4)
    return torch.einsum("cnk,nk->nc", vals, w4)


def _scatter(res: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor, nodes: int) -> torch.Tensor:
    """A^T r: scatter (N, 2) residuals back to (2, nodes)."""
    contrib = (res[:, :, None] * w4[:, None, :]).transpose(0, 1).reshape(2, -1)  # (2, N*4)
    zero = torch.zeros((2, nodes), dtype=res.dtype, device=res.device)
    return zero.index_add(1, idx.reshape(-1), contrib)


def _diff_h(m):  # (2, Hm, Wm) -> (2, Hm, Wm-1)
    return m[:, :, 1:] - m[:, :, :-1]


def _diff_v(m):  # (2, Hm, Wm) -> (2, Hm-1, Wm)
    return m[:, 1:, :] - m[:, :-1, :]


def _diff_h_t(d):  # adjoint of _diff_h: (D^T y)[j] = y[j-1] - y[j]
    return F.pad(d, (1, 0)) - F.pad(d, (0, 1))


def _diff_v_t(d):
    return F.pad(d, (0, 0, 1, 0)) - F.pad(d, (0, 0, 0, 1))


def estimate(
    src: torch.Tensor,  # (N, 2) previous-frame points, detection px
    dst: torch.Tensor,  # (N, 2) tracked points
    weights: torch.Tensor,  # (N,) confidence in [0, 1] (0 = unmatched)
    global_fit: WarpField,  # global-motion (homography) field
    size: tuple[int, int],  # detection frame size (h, w)
    settings: MeshMotionSettings,
    prev_local: WarpField | None = None,  # previous mesh MINUS its global fit
    prev_weight_scale: torch.Tensor | float = 1.0,  # 0 disables (first frame)
) -> tuple[WarpField, torch.Tensor, torch.Tensor]:
    """Fit the mesh.  Returns (field, inliers, mean_residual_px).

    The solved offsets live at the tracked (current-frame) positions and
    point back toward the previous frame, o(dst) = src - dst, as in
    WarpField.from_homography.  Two regularization pulls, as in the JAX
    package: `settings.temporal_weight` toward `global_fit + prev_local`
    (per node, weakened where features support the node), scaled by
    `prev_weight_scale`, and `settings.global_weight` toward `global_fit`.
    The CG warm-starts from the temporal target when it carries weight,
    else from the global fit.
    """
    field, inliers, mean_res = solve([(src, dst, weights)], global_fit, size, settings,
                                     prev_local, prev_weight_scale)
    return field, inliers[0], mean_res


def _psum(parts: list[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The sum of per-shard partials, gathered on `dev` (one partial: itself)."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def solve(
    shards: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    global_fit: WarpField,
    size: tuple[int, int],
    settings: MeshMotionSettings,
    prev_local: WarpField | None = None,
    prev_weight_scale: torch.Tensor | float = 1.0,
) -> tuple[WarpField, torch.Tensor, list[torch.Tensor]]:
    """`estimate` over features split into shards, (src, dst, weights) each
    on its own device: every feature sum (the operator's A^T W A x, the
    right-hand side, the temporal diagonal, the residual mean) is a sum of
    per-shard partials gathered on the device of `global_fit`, where the CG
    runs.  Returns the field, each shard's inliers on its device, and the
    mean residual."""
    hm, wm = global_fit.field_shape
    nodes = hm * wm
    dev = global_fit.offsets.device

    feats = []
    for src, dst, weights in shards:
        idx, w4 = _bilinear_weights(dst, (hm, wm), size)
        # Observed backward displacement (dy, dx) in px.
        d_obs = torch.stack([src[:, 1] - dst[:, 1], src[:, 0] - dst[:, 0]], dim=-1)
        feats.append((idx, w4, d_obs, weights))

    x_glob = _to_px(global_fit.offsets, size)  # solve in px units
    lam_g = settings.global_weight
    lam_r = settings.rigidity_weight
    if prev_local is None:
        lam_t = 0.0
        x_tgt = x0 = x_glob
    else:
        # The tracker passes a device tensor, which this neither copies nor
        # reads back.
        lam_t = settings.temporal_weight * torch.as_tensor(prev_weight_scale, dtype=torch.float32,
                                                           device=dev)
        x_tgt = x_glob + _to_px(prev_local.offsets, size)
        x0 = torch.where(lam_t > 0, x_tgt, x_glob)

    def temporal_diag(wfs):
        """Per-node temporal weight lam_t / (1 + (s / s0)^2), s the node's
        feature support (the diagonal of the feature normal matrix)."""
        s = _psum([torch.zeros(nodes, dtype=torch.float32, device=idx.device).index_add(
            0, idx.reshape(-1), (wf[:, None] * w4 * w4).reshape(-1))
            for (idx, w4, _, _), wf in zip(feats, wfs)], dev).reshape(1, hm, wm)
        return lam_t / (1.0 + (s / settings.temporal_support_scale) ** 2)

    def normal_op(x, wfs, lam_tn):
        """A^T W A x of the stacked system (feature, rigidity, temporal,
        global)."""
        feat = _psum([_scatter(_sample(x.to(idx.device), idx, w4) * wf[:, None], idx, w4, nodes)
                      for (idx, w4, _, _), wf in zip(feats, wfs)], dev).reshape(2, hm, wm)
        rig = lam_r * (_diff_h_t(_diff_h(x)) + _diff_v_t(_diff_v(x)))
        return feat + rig + lam_tn * x + lam_g * x

    def rhs(wfs, lam_tn):
        feat = _psum([_scatter(d_obs * wf[:, None], idx, w4, nodes)
                      for (idx, w4, d_obs, _), wf in zip(feats, wfs)], dev).reshape(2, hm, wm)
        return feat + lam_tn * x_tgt + lam_g * x_glob

    def cg_solve(b, wfs, lam_tn, x):
        r = b - normal_op(x, wfs, lam_tn)
        p = r
        rs = (r * r).sum()
        for _ in range(settings.cg_iterations):
            ap = normal_op(p, wfs, lam_tn)
            alpha = rs / torch.clamp((p * ap).sum(), min=1e-12)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = (r * r).sum()
            p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
            rs = rs_new
        return x

    def err2(x):
        """Each shard's squared residuals, (N_i,) on its device."""
        out = []
        for idx, w4, d_obs, _ in feats:
            res = _sample(x.to(idx.device), idx, w4) - d_obs  # (N, 2)
            out.append((res * res).sum(dim=-1))
        return out

    tau2 = settings.inlier_threshold_px ** 2
    x = x0
    wfs = [weights for _, _, _, weights in feats]
    for _ in range(settings.irls_rounds):
        lam_tn = temporal_diag(wfs)
        x = cg_solve(rhs(wfs, lam_tn), wfs, lam_tn, x)
        wfs = [weights * torch.clamp(1.0 - e2 / tau2, min=0.0)
               for (_, _, _, weights), e2 in zip(feats, err2(x))]

    inliers, res_sum, n_matched = [], [], []
    for (_, _, _, weights), e2 in zip(feats, err2(x)):
        matched = weights > 0
        inliers.append((e2 < tau2) & matched)
        res_sum.append((torch.sqrt(e2) * matched).sum())
        n_matched.append(matched.sum())
    mean_res = _psum(res_sum, dev) / torch.clamp(_psum(n_matched, dev), min=1)
    return WarpField(offsets=_to_norm(x, size)), inliers, mean_res
