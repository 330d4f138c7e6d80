"""RCAS: Robust Contrast-Adaptive Sharpening (counterpart of
livevisionkit_tpu/ops/rcas.py).

Reference parity: the `rcas` OpenCL kernel (reference Functions/OpenCL/
Sources/FSR.cl:460-537): per pixel, the 4-neighbour cross b (above),
d (left), f (right), h (below) around e drives a negative sharpening lobe,
limited per channel so no ringing is introduced, taken as the worst case
over channels, clamped to [-0.1875, 0] and scaled by the sharpness:
out = ((b + d + f + h) * lobe + e) / (4 * lobe + 1).  Border pixels copy
through (:484-491).

`rcas_plain` is the JAX package's XLA form; the CUDA kernel
(csrc/rcas.cu) computes the same operations in the same order.  `rcas` is
the custom op ``lvk::rcas``; under `torch.func.vmap` over streams its rule
calls ``lvk::rcas_batched`` once a tick (ops/remap.py does the same for
the warp).
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import rcas as rcas_kernel
from livevisionkit_tpu_torch.utils.batching import stream_first


def rcas_plain(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """`rcas` as plain PyTorch ops on any device: the CPU path, and the
    reference the RCAS kernel is held against on the card.  Only interior
    pixels are filtered (the border is copied), so the cross needs no
    padding."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    e = img[:, 1:-1, 1:-1]
    b = img[:, :-2, 1:-1]
    h = img[:, 2:, 1:-1]
    d = img[:, 1:-1, :-2]
    f = img[:, 1:-1, 2:]

    mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    # Per-channel limiters (FSR.cl:515-526).
    hit_min = torch.minimum(mn4, e) / (4.0 * torch.clamp(mx4, min=1e-6))
    hit_max = (1.0 - torch.maximum(mx4, e)) / torch.clamp(4.0 * mn4 - 4.0, max=-1e-6)
    lobe_c = torch.maximum(-hit_min, hit_max)
    # Worst case across channels, clamped to the stable range.
    lobe = torch.clamp(lobe_c.amax(dim=0, keepdim=True), -0.1875, 0.0) * sharpness
    inner = ((b + d + f + h) * lobe + e) * (1.0 / (4.0 * lobe + 1.0))

    out = img.clone()
    out[:, 1:-1, 1:-1] = inner
    return out[0] if squeeze else out


def rcas_batched_plain(imgs: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """`rcas_plain` over a leading stream axis, by torch.func.vmap: the
    batched rule's CPU path, and the reference the RCAS kernel's stream
    axis is held against on the card."""
    return torch.func.vmap(lambda im: rcas_plain(im, sharpness))(imgs)


def rcas(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen float32 (C, H, W) or (H, W) planes; `sharpness` in [0, 1].
    A CUDA tensor launches the RCAS kernel, a CPU tensor takes
    `rcas_plain`.  It is the custom op ``lvk::rcas``, whose vmap rule makes
    `torch.func.vmap` over streams ONE call of ``lvk::rcas_batched``."""
    return _rcas_op(img, float(sharpness))


_SCHEMA = "(Tensor img, float sharpness) -> Tensor"


@torch.library.custom_op("lvk::rcas", mutates_args=(), schema=_SCHEMA)
def _rcas_op(img, sharpness):
    """One frame: the RCAS kernel for a CUDA tensor, `rcas_plain` for a CPU
    one."""
    if img.is_cuda:
        return rcas_kernel.rcas(img, sharpness)
    return rcas_plain(img, sharpness)


@torch.library.custom_op("lvk::rcas_batched", mutates_args=(), schema=_SCHEMA)
def _rcas_batched_op(img, sharpness):
    """S frames (S, C, H, W) or (S, H, W): one launch of the RCAS kernel
    for CUDA tensors, the plain version on the stack for CPU ones."""
    if img.is_cuda:
        return rcas_kernel.rcas_batched(img, sharpness)
    return rcas_batched_plain(img, sharpness)


@_rcas_op.register_fake
@_rcas_batched_op.register_fake
def _rcas_fake(img, sharpness):
    return img.new_empty(img.shape)


def _rcas_vmap(info, in_dims, img, sharpness):
    """vmap rule of ``lvk::rcas``: one batched launch for all streams; an
    unbatched frame is broadcast at stream stride 0, not copied."""
    return _rcas_batched_op(stream_first(img, in_dims[0], info.batch_size), sharpness), 0


_rcas_op.register_vmap(_rcas_vmap)
