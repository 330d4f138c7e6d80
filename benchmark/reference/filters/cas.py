"""CAS in plain PyTorch, frozen here as the reference of the port's
`CASFilter` (FidelityFX CAS, ffx_cas_mod.h:47-170, CAS_SLOW +
CAS_BETTER_DIAGONALS): per pixel over its 3x3 neighbourhood, amp =
sqrt(saturate(min(mn, 2 - mx) / mx)) of the soft min and max, w = amp *
peak with peak = -1 / lerp(8, 5, sharpness), out = saturate(((b + d + f +
h) w + e) / (4 w + 1))."""

from __future__ import annotations

import torch
import torch.nn.functional as F

def apply(img: torch.Tensor, settings: dict) -> torch.Tensor:
    """Sharpen (C, H, W) planes in [0, 1]; the border sees its edge
    replicated."""
    s = min(max(float(settings["sharpness"]), 0.0), 1.0)
    peak = -1.0 / (8.0 + (5.0 - 8.0) * s)
    p = F.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    a, b, c = p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:]
    d, e, f = p[:, 1:-1, :-2], img, p[:, 1:-1, 2:]
    g, h, i = p[:, 2:, :-2], p[:, 2:, 1:-1], p[:, 2:, 2:]
    mn = torch.minimum(torch.minimum(torch.minimum(d, e), torch.minimum(f, b)), h)
    mn = mn + torch.minimum(torch.minimum(mn, torch.minimum(a, c)), torch.minimum(g, i))
    mx = torch.maximum(torch.maximum(torch.maximum(d, e), torch.maximum(f, b)), h)
    mx = mx + torch.maximum(torch.maximum(mx, torch.maximum(a, c)), torch.maximum(g, i))
    amp = torch.sqrt(torch.clamp(torch.minimum(mn, 2.0 - mx) / torch.clamp(mx, min=1e-6), 0.0, 1.0))
    w = amp * peak
    return torch.clamp(((b + d + f + h) * w + e) / (4.0 * w + 1.0), 0.0, 1.0)
