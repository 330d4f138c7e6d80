"""Local (mesh) motion estimation: the WarpField least-squares solve
(counterpart of livevisionkit_tpu/vision/mesh_motion.py; reference
Vision/FrameTracker.cpp:200-321, estimate_local_motions).

A sparse least-squares fit of an (Hm, Wm) mesh to the matched features:
bilinear feature constraints, first-difference rigidity constraints, a
temporal pull toward the previous frame's local mesh and a weak pull
toward the global (homography) fit, solved by conjugate gradient on the
normal equations:

  * feature term: A, the bilinear sampling of the mesh at the tracked
    points, as a dense (N, nodes) matrix built once per solve
    (`_operator`, four nonzeros a row), and its normal matrix A^T W A
    (`_normal`) once per IRLS round;
  * rigidity term: first-difference stencils along both mesh axes and their
    adjoints, as a (nodes, nodes) matrix built once per solve;
  * temporal and global terms: diagonal.

The terms' sum is one (nodes, nodes) matrix a round, so a CG iteration
applies the whole operator with one matrix product.

The JAX package applies A by a gather and A^T by `segment_sum`, matrix
free; the products here sum each node's terms in a fixed order as that
does (an `index_add` would add with atomics on the card, in no fixed
order), so two solves on the same inputs, op by op or replayed as a CUDA
graph, agree bit for bit.  A card solve agrees with the CPU's within
rounding.

Outliers are down-weighted by IRLS rounds with a truncated quadratic.  The
JAX package's `fori_loop` is a Python loop over the static
`cg_iterations`, and every data-dependent choice is a `torch.where`: no
early exit on the residual and no Python branch on a tensor, so the solve
never waits for the device, and it batches under `torch.func.vmap` (every
op here has a batching rule).  The mesh is solved in detection-frame
pixels and returned normalized.  `solve` is the same fit over features
split into shards on several devices (parallel/distributed_solve.py);
`estimate` is its one shard.
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


def _operator(idx: torch.Tensor, w4: torch.Tensor, nodes: int) -> torch.Tensor:
    """A as a dense (N, nodes) matrix: row i holds feature i's four
    bilinear weights at its four (distinct) nodes, so A x = `_sample`."""
    one_hot = (idx[:, :, None] == torch.arange(nodes, device=idx.device)).to(w4.dtype)  # (N, 4, nodes)
    return (w4[:, :, None] * one_hot).sum(dim=1)


def _scatter(res: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A^T r: scatter (N, 2) residuals back to (2, nodes) (`a` the
    `_operator`)."""
    return res.transpose(0, 1) @ a


def _normal(a: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """The feature normal matrix A^T diag(wf) A, (nodes, nodes).  Its
    diagonal is each node's support, sum_i wf_i w4_ik^2 (a feature's four
    nodes are distinct)."""
    return a.transpose(0, 1) @ (wf[:, None] * a)


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
    on its own device: every feature sum (the normal matrix A^T W A, the
    right-hand side, the residual mean) is a sum of per-shard partials
    gathered on the device of `global_fit`, where the CG runs.  Returns
    the field, each shard's inliers on its device, and the mean residual."""
    hm, wm = global_fit.field_shape
    nodes = hm * wm
    dev = global_fit.offsets.device

    feats = []
    for src, dst, weights in shards:
        idx, w4 = _bilinear_weights(dst, (hm, wm), size)
        # Observed backward displacement (dy, dx) in px.
        d_obs = torch.stack([src[:, 1] - dst[:, 1], src[:, 0] - dst[:, 0]], dim=-1)
        feats.append((idx, w4, d_obs, weights, _operator(idx, w4, nodes)))

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

    def temporal_diag(normal):
        """Per-node temporal weight lam_t / (1 + (s / s0)^2), s the node's
        feature support (the diagonal of the feature normal matrix)."""
        s = torch.diagonal(normal).reshape(1, hm, wm)
        return lam_t / (1.0 + (s / settings.temporal_support_scale) ** 2)

    # The rigidity term's matrix D_h^T D_h + D_v^T D_v: its stencils
    # applied to each node's unit field (row j is the image of node j).
    eye = torch.eye(nodes, dtype=torch.float32, device=dev).reshape(nodes, hm, wm)
    rigidity = (_diff_h_t(_diff_h(eye)) + _diff_v_t(_diff_v(eye))).reshape(nodes, nodes)

    def system(normal, lam_tn):
        """The normal matrix of the stacked system (feature, rigidity,
        temporal, global), (nodes, nodes): a CG iteration applies it with
        one product."""
        return normal + lam_r * rigidity + torch.diag_embed((lam_tn + lam_g).reshape(nodes))

    def normal_op(x, k):
        return (x.reshape(2, nodes) @ k).reshape(2, hm, wm)

    def rhs(wfs, lam_tn):
        feat = _psum([_scatter(d_obs * wf[:, None], a)
                      for (_, _, d_obs, _, a), wf in zip(feats, wfs)], dev).reshape(2, hm, wm)
        return feat + lam_tn * x_tgt + lam_g * x_glob

    def cg_solve(b, k, x):
        r = b - normal_op(x, k)
        p = r
        rs = (r * r).sum()
        for _ in range(settings.cg_iterations):
            ap = normal_op(p, k)
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
        for idx, w4, d_obs, _, _ in feats:
            res = _sample(x.to(idx.device), idx, w4) - d_obs  # (N, 2)
            out.append((res * res).sum(dim=-1))
        return out

    tau2 = settings.inlier_threshold_px ** 2
    x = x0
    wfs = [weights for _, _, _, weights, _ in feats]
    for _ in range(settings.irls_rounds):
        normal = _psum([_normal(a, wf) for (*_, a), wf in zip(feats, wfs)], dev)
        lam_tn = temporal_diag(normal)
        x = cg_solve(rhs(wfs, lam_tn), system(normal, lam_tn), x)
        wfs = [weights * torch.clamp(1.0 - e2 / tau2, min=0.0)
               for (_, _, _, weights, _), e2 in zip(feats, err2(x))]

    inliers, res_sum, n_matched = [], [], []
    for (_, _, _, weights, _), e2 in zip(feats, err2(x)):
        matched = weights > 0
        inliers.append((e2 < tau2) & matched)
        res_sum.append((torch.sqrt(e2) * matched).sum())
        n_matched.append(matched.sum())
    mean_res = _psum(res_sum, dev) / torch.clamp(_psum(n_matched, dev), min=1)
    return WarpField(offsets=_to_norm(x, size)), inliers, mean_res
