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
(csrc/rcas.cu) computes the same operations in the same order.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.ops.cuda_kernels import rcas as rcas_kernel


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


def rcas(img: torch.Tensor, sharpness: float = 0.8) -> torch.Tensor:
    """Sharpen float32 (C, H, W) or (H, W) planes; `sharpness` in [0, 1].
    A CUDA tensor launches the RCAS kernel, a CPU tensor takes
    `rcas_plain`."""
    if img.is_cuda:
        return rcas_kernel.rcas(img, sharpness)
    return rcas_plain(img, sharpness)
