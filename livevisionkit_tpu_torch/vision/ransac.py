"""Robust global motion estimation: batched-hypothesis RANSAC + IRLS polish
(counterpart of livevisionkit_tpu/vision/ransac.py; reference
FrameTracker::estimate_global_motion, FrameTracker.cpp:325-375).

K minimal solvers (4-point DLT, 2-point similarity) run as one batch, all
K x N residuals evaluate at once, truncated-quadratic scores reduce per
hypothesis and `argmax` picks the winner, which IRLS polishes (Hartley-
normalized weighted DLT, gauge-fixed Cholesky).  Everything stays on the
device: no value is read back to the host.

The minimal sets are drawn here (`sample_indices`, on the caller's
generator); everything after the draw goes through the custom op
``lvk::ransac_estimate``: CUDA tensors launch the RANSAC + IRLS kernel
(ops/cuda_kernels/ransac.py, one launch), CPU tensors take
`estimate_plain`, the kernel's reference.  Its vmap rule turns
`torch.func.vmap` over streams into one call of
``lvk::ransac_estimate_batched``: one launch for all S streams on the card,
`estimate_plain` under vmap on the CPU.  The draw stays outside the op, so
vmap's ``randomness="different"`` still draws per stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.config import MotionEstimationSettings
from livevisionkit_tpu_torch.models.homography import Homography, _adjugate, dlt4
from livevisionkit_tpu_torch.ops.cuda_kernels import ransac as ransac_kernel
from livevisionkit_tpu_torch.utils.batching import stream_first

_SCHEMA = ("(Tensor src, Tensor dst, Tensor valid, Tensor indices, Tensor use_h, float tau, "
           "int rounds, int min_samples) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")


@dataclass(frozen=True)
class GlobalMotion:
    homography: Homography
    inliers: torch.Tensor  # (N,) bool
    stability: torch.Tensor  # 0-d inlier ratio in [0, 1]
    ok: torch.Tensor  # 0-d bool: model finite & minimally supported


def _all_finite(m: torch.Tensor) -> torch.Tensor:
    """Per-matrix finiteness of (..., 3, 3)."""
    return torch.isfinite(m).all(dim=-1).all(dim=-1)


def _transfer_errors_sq(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared forward-transfer error |H(src) - dst|^2; h: (..., 3, 3)."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype, device=src.device)
    ph = torch.cat([src, ones], dim=-1)  # (N, 3)
    out = torch.einsum("...ij,nj->...ni", h, ph)
    denom = out[..., 2]
    safe = torch.where(denom.abs() > 1e-8, denom, 1e-8)
    proj = out[..., :2] / safe[..., None]
    return ((proj - dst) ** 2).sum(dim=-1)


def _magsac_score(err_sq: torch.Tensor, valid: torch.Tensor, tau: float) -> torch.Tensor:
    """Truncated-quadratic score: sum over valid points of max(0, 1 - e^2/tau^2)."""
    w = torch.clamp(1.0 - err_sq / (tau * tau), min=0.0)
    return (w * valid).sum(dim=-1)


def _similarity_from_2pts(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact 4-DoF similarity from 2 correspondences, batched: p, q are
    (K, 2, 2) -> (K, 3, 3).  a + ib = (q2 - q1) / (p2 - p1); t = q1 - M p1."""
    dp = p[:, 1] - p[:, 0]
    dq = q[:, 1] - q[:, 0]
    denom = (dp * dp).sum(dim=-1)
    inv = torch.where(denom > 1e-12, 1.0 / denom, float("nan"))
    a = (dq[:, 0] * dp[:, 0] + dq[:, 1] * dp[:, 1]) * inv
    b = (dq[:, 1] * dp[:, 0] - dq[:, 0] * dp[:, 1]) * inv
    tx = q[:, 0, 0] - (a * p[:, 0, 0] - b * p[:, 0, 1])
    ty = q[:, 0, 1] - (b * p[:, 0, 0] + a * p[:, 0, 1])
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([a, -b, tx], dim=-1),
        torch.stack([b, a, ty], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization transform (3, 3) for weighted points."""
    wsum = torch.clamp(w.sum(), min=1e-6)
    mean = (pts * w[:, None]).sum(dim=0) / wsum
    d = torch.sqrt(((pts - mean) ** 2).sum(dim=-1))
    mean_d = (d * w).sum() / wsum
    s = torch.where(mean_d > 1e-6, 2.0**0.5 / mean_d, 1.0)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[0]]),
        torch.stack([zero, s, -s * mean[1]]),
        torch.stack([zero, zero, one]),
    ])


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det); NaN when singular."""
    adj = _adjugate(m)
    det = m[0, 0] * adj[0, 0] + m[0, 1] * adj[1, 0] + m[0, 2] * adj[2, 0]
    return adj / torch.where(det.abs() > 1e-20, det, float("nan"))


def _weighted_dlt(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography with the h33 = 1 gauge: a Cholesky solve of
    the 8x8 block of A^T W A."""
    t_src = _normalization(src, w)
    t_dst = _normalization(dst, w)
    ones = torch.ones((src.shape[0], 1), dtype=src.dtype, device=src.device)
    sn = torch.cat([src, ones], dim=-1) @ t_src.T
    dn = torch.cat([dst, ones], dim=-1) @ t_dst.T
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    a = torch.cat([r1, r2], dim=0)  # (2N, 9)
    ww = torch.cat([w, w], dim=0)
    m = (a * ww[:, None]).T @ a  # (9, 9) PSD normal matrix
    # jax's cho_factor yields NaN on a non-PD block and irls_step then keeps
    # the previous model; torch.linalg.cholesky would raise (a host sync on
    # CUDA), so cholesky_ex's status is turned into NaN instead.  The solve
    # is two triangular solves, which report no status to the host.
    chol, info = torch.linalg.cholesky_ex(m[:8, :8])
    chol = torch.where(info == 0, chol, float("nan"))
    y = torch.linalg.solve_triangular(chol, -m[:8, 8:9], upper=False)
    h8 = torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]
    h = torch.cat([h8, torch.ones(1, dtype=h8.dtype, device=h8.device)]).reshape(3, 3)
    h_full = _inv3(t_dst) @ h @ t_src
    return h_full / h_full[2, 2]


def _weighted_similarity(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares similarity (a, b, tx, ty) in closed form."""
    wsum = torch.clamp(w.sum(), min=1e-6)
    ms = (src * w[:, None]).sum(dim=0) / wsum
    md = (dst * w[:, None]).sum(dim=0) / wsum
    s = src - ms
    d = dst - md
    denom = (w * (s * s).sum(dim=-1)).sum()
    inv = torch.where(denom > 1e-9, 1.0 / denom, 0.0)
    a = (w * (d[:, 0] * s[:, 0] + d[:, 1] * s[:, 1])).sum() * inv
    b = (w * (d[:, 1] * s[:, 0] - d[:, 0] * s[:, 1])).sum() * inv
    tx = md[0] - (a * ms[0] - b * ms[1])
    ty = md[1] - (b * ms[0] + a * ms[1])
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([a, -b, tx]),
        torch.stack([b, a, ty]),
        torch.stack([zero, zero, one]),
    ])


def sample_indices(
    valid: torch.Tensor, k: int, generator: torch.Generator
) -> torch.Tensor:
    """(k, 4) feature indices drawn uniformly, with replacement, from the
    valid ones — the distribution of the JAX version's categorical draw over
    0 / -inf logits (the numbers differ).  Inverse-CDF sampling keeps it on
    the device without a host sync; with no valid feature it draws index 0."""
    cdf = torch.cumsum(valid.to(torch.float32), dim=0)
    u = torch.rand((k, 4), generator=generator, device=valid.device)
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def estimate_plain(
    src: torch.Tensor,  # (N, 2) previous-frame points (x, y)
    dst: torch.Tensor,  # (N, 2) tracked positions
    valid: torch.Tensor,  # (N,) bool match mask
    indices: torch.Tensor,  # (K, 4) int64 minimal sets
    use_h: torch.Tensor,  # 0-d bool: the homography, else the similarity
    tau: float,
    rounds: int,
    min_samples: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RANSAC kernel's plain version on any device: the safe model
    (3, 3), the (N,) inliers, the 0-d stability and `ok`, and the (2,)
    winners' indices (homography, similarity).  Both models are estimated
    and `use_h` picks one."""
    vf = valid.to(torch.float32)
    p4 = src[indices]  # (K, 4, 2)
    q4 = dst[indices]

    h_hyp = dlt4(p4, q4)
    err_h = _transfer_errors_sq(h_hyp, src, dst)  # (K, N)
    score_h = torch.where(_all_finite(h_hyp), _magsac_score(err_h, vf, tau), float("-inf"))

    s_hyp = _similarity_from_2pts(p4[:, :2], q4[:, :2])
    err_s = _transfer_errors_sq(s_hyp, src, dst)
    score_s = torch.where(_all_finite(s_hyp), _magsac_score(err_s, vf, tau), float("-inf"))

    arg_h, arg_s = torch.argmax(score_h), torch.argmax(score_s)
    best_h = h_hyp.index_select(0, arg_h.reshape(1))[0]
    best_s = s_hyp.index_select(0, arg_s.reshape(1))[0]
    model = torch.where(use_h, best_h, best_s)

    for _ in range(rounds):
        e = _transfer_errors_sq(model, src, dst)
        w = vf * torch.clamp(1.0 - e / (tau * tau), min=0.0)
        refined = torch.where(use_h, _weighted_dlt(src, dst, w), _weighted_similarity(src, dst, w))
        # Keep the previous model if refinement exploded.
        model = torch.where(torch.isfinite(refined).all(), refined, model)

    err = _transfer_errors_sq(model, src, dst)
    inliers = (err < tau * tau) & valid
    n_valid = torch.clamp(vf.sum(), min=1.0)
    stability = inliers.to(torch.float32).sum() / n_valid
    ok = (
        torch.isfinite(model).all()
        & (vf.sum() >= min_samples)
        & (inliers.sum() >= min_samples)
    )
    safe_model = torch.where(ok, model, torch.eye(3, dtype=model.dtype, device=model.device))
    return safe_model, inliers, stability, ok, torch.stack([arg_h, arg_s])


def estimate_batched_plain(src, dst, valid, indices, use_h, tau: float, rounds: int,
                           min_samples: int) -> tuple[torch.Tensor, ...]:
    """`estimate_plain` over a leading stream axis of every operand, by
    torch.func.vmap.  The batched op's CPU path, and the reference the
    kernel's stream axis is held against on the card."""
    return torch.func.vmap(
        lambda a, b, v, i, u: estimate_plain(a, b, v, i, u, tau, rounds, min_samples)
    )(src, dst, valid, indices, use_h)


@torch.library.custom_op("lvk::ransac_estimate", mutates_args=(), schema=_SCHEMA)
def _ransac_op(src, dst, valid, indices, use_h, tau, rounds, min_samples):
    """One stream: the RANSAC kernel for CUDA tensors, `estimate_plain` for
    CPU ones."""
    if src.is_cuda:
        return ransac_kernel.ransac_estimate(src.contiguous(), dst.contiguous(), valid.contiguous(),
                                             indices.contiguous(), use_h, tau, rounds, min_samples)
    return estimate_plain(src, dst, valid, indices, use_h, tau, rounds, min_samples)


@torch.library.custom_op("lvk::ransac_estimate_batched", mutates_args=(), schema=_SCHEMA)
def _ransac_batched_op(src, dst, valid, indices, use_h, tau, rounds, min_samples):
    """S streams, stream axis first: one launch of the RANSAC kernel for
    CUDA tensors, `estimate_plain` under vmap for CPU ones."""
    if src.is_cuda:
        return ransac_kernel.ransac_estimate(src, dst, valid, indices, use_h, tau, rounds,
                                             min_samples)
    return estimate_batched_plain(src, dst, valid, indices, use_h, tau, rounds, min_samples)


@_ransac_op.register_fake
@_ransac_batched_op.register_fake
def _ransac_fake(src, dst, valid, indices, use_h, tau, rounds, min_samples):
    lead = src.shape[:-2]
    return (src.new_empty(lead + (3, 3)), valid.new_empty(valid.shape),
            src.new_empty(lead), valid.new_empty(lead), indices.new_empty(lead + (2,)))


def _ransac_vmap(info, in_dims, src, dst, valid, indices, use_h, tau, rounds, min_samples):
    """vmap rule of ``lvk::ransac_estimate``: all streams in one batched
    call; unbatched operands are broadcast at stream stride 0."""
    n = info.batch_size
    ops = [stream_first(t, d, n) for t, d in zip((src, dst, valid, indices, use_h), in_dims[:5])]
    return _ransac_batched_op(*ops, tau, rounds, min_samples), (0, 0, 0, 0, 0)


_ransac_op.register_vmap(_ransac_vmap)


def estimate(
    src: torch.Tensor,  # (N, 2) previous-frame points (x, y)
    dst: torch.Tensor,  # (N, 2) tracked positions
    valid: torch.Tensor,  # (N,) bool match mask
    generator: torch.Generator | None,
    settings: MotionEstimationSettings,
    use_homography: torch.Tensor | bool = True,
    min_samples: int = 8,
    indices: torch.Tensor | None = None,
) -> GlobalMotion:
    """Fit a robust global motion model to the masked correspondences.

    `use_homography` selects the 8-DoF model, else a 4-DoF similarity (a
    0-d bool tensor or a bool).  `indices` ((K, 4) int) replaces the
    random draw, so a test can feed the same minimal sets to both packages;
    otherwise `generator` draws them.
    """
    k = settings.hypotheses
    idx = sample_indices(valid, k, generator) if indices is None else indices.to(src.device).long()
    use_h = torch.as_tensor(use_homography, dtype=torch.bool, device=src.device)
    m, inliers, stability, ok, _ = _ransac_op(
        src, dst, valid, idx, use_h, float(settings.inlier_threshold_px),
        settings.refine_iterations, min_samples)
    return GlobalMotion(homography=Homography(m=m), inliers=inliers, stability=stability, ok=ok)
