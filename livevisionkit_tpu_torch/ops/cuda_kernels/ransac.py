"""Launch wrapper of the RANSAC + IRLS kernel (csrc/ransac.cu, K7).

Replaces no TPU kernel: the JAX package leaves vision/ransac.estimate to
XLA, which fuses it; the port's plain version, vision/ransac.estimate_plain
(under torch.func.vmap for a batch of streams), is ~1,100 small PyTorch
ops, ~1,100 nodes of a captured step.  The kernel runs all of it after the
random draw in one launch, with the plain version's rules.

What bounds it on the H100: latency.  At the main path's shapes (510
features, 256 hypotheses, 4 IRLS rounds) it is ~6.6 M f32 operations over
~17 KB of operands, too little to fill 132 SMs; its time is the chain of
dependent phases.  Its design: a cluster of 8 blocks of 512 threads per
stream, each block scoring an eighth of the hypotheses, the first one
taking the winners from the others' shared memory and running IRLS; every
operand in shared memory, reductions by warp shuffles in a fixed order (no
atomics: every launch gives the same bits).  S streams are S clusters of
one launch.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import build
from livevisionkit_tpu_torch.utils.batching import blocks_contiguous

_MAX_POINTS = 2048  # csrc/ransac.cu: kMaxN
_MAX_HYPOTHESES = 1024  # kMaxK
_MAX_STREAMS = 65535


def ransac_estimate(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    indices: torch.Tensor,
    use_h: torch.Tensor,
    tau: float,
    rounds: int,
    min_samples: int,
) -> tuple[torch.Tensor, ...]:
    """Fit the global motion of N correspondences from K drawn minimal
    sets, in one launch.

    Solo: (N, 2) f32 `src` and `dst`, (N,) bool `valid`, (K, 4) int64
    `indices` and a 0-d bool `use_h`; returns the (3, 3) model (identity
    where not ok), the (N,) bool inliers, the 0-d stability and `ok`, and
    the (2,) int64 winners of the homography and similarity scores.
    Batched over S streams: each operand with a leading stream axis (a
    stream stride of 0 broadcasts it), and each result too.  An index
    outside [0, N) is clamped into it."""
    batched = src.ndim == 3
    lead = 1 if batched else 0
    tensors = {"src": src, "dst": dst, "valid": valid, "indices": indices, "use_h": use_h}
    dtypes = {"src": torch.float32, "dst": torch.float32, "valid": torch.bool,
              "indices": torch.int64, "use_h": torch.bool}
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"RANSAC kernel takes {name} as {dtypes[name]}, got {t.dtype}")
    s = src.shape[0] if batched else 1
    n = src.shape[lead]
    k = indices.shape[lead] if indices.ndim == 2 + lead else -1
    if src.ndim not in (2, 3) or src.shape[lead:] != (n, 2) or dst.shape != src.shape:
        raise ValueError("src and dst must both be (N, 2), or (S, N, 2) for S streams")
    if valid.shape != src.shape[:-1] or indices.shape != src.shape[:lead] + (k, 4):
        raise ValueError("valid must be (N,) and indices (K, 4), with the streams' axis first")
    if use_h.shape != src.shape[:lead]:
        raise ValueError("use_h must be 0-d, or (S,) for S streams")
    if not 1 <= n <= _MAX_POINTS:
        raise ValueError(f"RANSAC kernel takes 1..{_MAX_POINTS} points, got {n}")
    if not 1 <= k <= _MAX_HYPOTHESES:
        raise ValueError(f"RANSAC kernel takes 1..{_MAX_HYPOTHESES} hypotheses, got {k}")
    if not 1 <= s <= _MAX_STREAMS:
        raise ValueError(f"need 1..{_MAX_STREAMS} streams, got {s}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    dev = src.device
    for t in tensors.values():
        if not t.is_cuda or t.device != dev:
            raise ValueError("RANSAC kernel needs every tensor on one CUDA device")
    for t in (src, dst, valid, indices):
        if not (blocks_contiguous(t) if batched else t.is_contiguous()):
            raise ValueError("RANSAC kernel needs each stream's operands contiguous")
    model = torch.empty((s, 3, 3), dtype=torch.float32, device=dev)
    inliers = torch.empty((s, n), dtype=torch.bool, device=dev)  # the kernel writes 0 / 1 bytes
    stability = torch.empty((s,), dtype=torch.float32, device=dev)
    ok = torch.empty((s,), dtype=torch.bool, device=dev)
    best = torch.empty((s, 2), dtype=torch.int64, device=dev)
    ss = (lambda t: t.stride(0)) if batched else (lambda t: 0)
    # On the tensors' card, which need not be the current one (a mesh).
    with torch.cuda.device(dev):
        status = build.library().lvk_ransac(
            src.data_ptr(), ss(src), dst.data_ptr(), ss(dst), valid.data_ptr(), ss(valid),
            indices.data_ptr(), ss(indices), use_h.data_ptr(), ss(use_h), s, n, k,
            float(tau * tau), rounds, min_samples, model.data_ptr(), inliers.data_ptr(),
            stability.data_ptr(), ok.data_ptr(), best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(status, "ransac")
    ransac_estimate.launches += 1
    out = (model, inliers, stability, ok, best)
    return out if batched else tuple(t[0] for t in out)


# Launches of K7, solo and batched.
ransac_estimate.launches = 0
