"""CAS: AMD FidelityFX Contrast-Adaptive Sharpening (counterpart of
livevisionkit_tpu/ops/cas.py).

Reference parity: the `CasFilter` shader the reference ships as an OBS
filter (cas.effect:66 with CAS_SLOW + CAS_BETTER_DIAGONALS, kernel math in
ffx_cas_mod.h:47-170) and `CasSetup`'s sharpness mapping (ffx_cas.h:389):
peak = -1 / lerp(8, 5, saturate(sharpness)).  Per pixel over the 3x3
neighbourhood (a..i around e): soft min/max of the cross plus the full box
(both 2x-scaled), amp = sqrt(saturate(min(mn, 2 - mx) / mx)), w = amp *
peak, out = saturate(((b + d + f + h) w + e) / (4w + 1)) per channel.  The
reference's approximate rcp/sqrt are exact here, as in the JAX package.

`cas_plain` is a 3x3 stencil of plain PyTorch ops on one edge pad: the
JAX package has no Pallas kernel for it (one fused XLA pass there).  The
CUDA kernel (csrc/cas.cu, K9) computes the same operations in the same
order in one read and one write of the frame.  `cas` is the custom op
``lvk::cas``; under `torch.func.vmap` over streams its rule calls
``lvk::cas_batched`` once a tick (ops/rcas.py does the same for RCAS).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from livevisionkit_tpu_torch.ops.cuda_kernels import cas as cas_kernel
from livevisionkit_tpu_torch.utils.batching import stream_first


def cas_peak(sharpness: float) -> float:
    """CasSetup's sharpness -> filter peak mapping (ffx_cas.h:389)."""
    s = min(max(float(sharpness), 0.0), 1.0)
    return -1.0 / (8.0 + (5.0 - 8.0) * s)


def cas_plain(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """`cas` as plain PyTorch ops on any device: the CPU path, and the
    reference the CAS kernel is held against on the card.  Border pixels
    see the edge-replicated neighbourhood (the reference's texture Load
    clamps at the surface edge)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    e = img
    # Letters follow the reference's 3x3 grid (ffx_cas_mod.h:57-59).
    p = F.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    a, b, c = p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:]
    d, f = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    g, h, i = p[:, 2:, :-2], p[:, 2:, 1:-1], p[:, 2:, 2:]

    # Soft min/max: cross, then the box (CAS_BETTER_DIAGONALS, :84-110).
    mn = torch.minimum(torch.minimum(torch.minimum(d, e), torch.minimum(f, b)), h)
    mn2 = torch.minimum(torch.minimum(mn, torch.minimum(a, c)), torch.minimum(g, i))
    mn = mn + mn2
    mx = torch.maximum(torch.maximum(torch.maximum(d, e), torch.maximum(f, b)), h)
    mx2 = torch.maximum(torch.maximum(mx, torch.maximum(a, c)), torch.maximum(g, i))
    mx = mx + mx2

    # amp = saturate(min(mn, 2 - mx) / mx), sqrt-shaped (:119-141).
    amp = torch.sqrt(torch.clamp(torch.minimum(mn, 2.0 - mx) / torch.clamp(mx, min=1e-6), 0.0, 1.0))
    # Filter 0 w 0 / w 1 w / 0 w 0 with per-channel weights (CAS_SLOW, :158-168).
    w = amp * cas_peak(sharpness)
    out = torch.clamp(((b + d + f + h) * w + e) / (4.0 * w + 1.0), 0.0, 1.0)
    return out[0] if squeeze else out


def cas_batched_plain(imgs: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """`cas_plain` over a leading stream axis, by torch.func.vmap: the
    batched rule's CPU path, and the reference the CAS kernel's stream
    axis is held against on the card."""
    return torch.func.vmap(lambda im: cas_plain(im, sharpness))(imgs)


def cas(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen (C, H, W) or (H, W) planes in [0, 1]; `sharpness` in [0, 1].
    A CUDA tensor (float32 only) launches the CAS kernel, a CPU tensor
    takes `cas_plain`.  It is the custom op ``lvk::cas``, whose vmap rule
    makes `torch.func.vmap` over streams ONE call of ``lvk::cas_batched``."""
    return _cas_op(img, float(sharpness))


_SCHEMA = "(Tensor img, float sharpness) -> Tensor"


@torch.library.custom_op("lvk::cas", mutates_args=(), schema=_SCHEMA)
def _cas_op(img, sharpness):
    """One frame: the CAS kernel for a CUDA tensor (made contiguous first),
    `cas_plain` for a CPU one."""
    if img.is_cuda:
        return cas_kernel.cas(img.contiguous(), cas_peak(sharpness))
    return cas_plain(img, sharpness)


@torch.library.custom_op("lvk::cas_batched", mutates_args=(), schema=_SCHEMA)
def _cas_batched_op(img, sharpness):
    """S frames (S, C, H, W) or (S, H, W): one launch of the CAS kernel for
    CUDA tensors, the plain version on the stack for CPU ones."""
    if img.is_cuda:
        return cas_kernel.cas_batched(img, cas_peak(sharpness))
    return cas_batched_plain(img, sharpness)


@_cas_op.register_fake
@_cas_batched_op.register_fake
def _cas_fake(img, sharpness):
    return img.new_empty(img.shape)


def _cas_vmap(info, in_dims, img, sharpness):
    """vmap rule of ``lvk::cas``: one batched launch for all streams; an
    unbatched frame is broadcast at stream stride 0, not copied."""
    return _cas_batched_op(stream_first(img, in_dims[0], info.batch_size), sharpness), 0


_cas_op.register_vmap(_cas_vmap)
