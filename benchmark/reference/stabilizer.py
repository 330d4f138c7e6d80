"""The plain reference of a stabilizer chain, worked out from the true
camera path that rendered its input.

The stabilizer (reference Filters/StabilizationFilter.cpp, Vision/
PathSmoother.cpp, Math/WarpMesh.cpp) takes the motion prev -> current of
every frame as a field of backward offsets at corner-aligned control points
(normalized by the frame's size - 1), scaled by a trust that rises by
`trust_step` a frame from 0 after the first; the path is the sum of those
fields; a Gaussian over a window of 2N + 1 positions, its sigma servoed on
the drift, gives the smoothed path, and the correction (smoothed minus the
position N frames back, clamped to the corrective limit) warps the frame N
frames back, held in the queue's type (8-bit planes, or float32).  A 2 x 2 field warps by the homography
through its four corners; a mesh by its offsets bilinearly interpolated to
every pixel.  Here the motion is the truth, from the poses, where the
program estimates it from the pixels: the difference between the two is
the tracker's error, which the comparison measures.

Every step runs in the dtype given (float32 for the reference; bfloat16 for
the control), except the 8 x 8 solve of the corner homography, which has no
bfloat16 form and is solved in float64 before the map is formed in the
dtype.  Nothing here imports the program.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from reference import color


@dataclass
class Inputs:
    """One stream as the program received it: `poses[r]` maps frame r of
    the ring to the texture (float64 (T, 3, 3)); `frame(r)` gives ring frame r
    as (3, H, W) planes of the stabilizer's work format (YUV) in [0, 1];
    `ring_index(g)` is the ring frame of the stream's g-th input."""

    poses: np.ndarray
    frame: Callable[[int], torch.Tensor]
    ring_index: Callable[[int], int]


def true_motion(p_prev: np.ndarray, p_cur: np.ndarray, field: tuple[int, int],
                size: tuple[int, int]) -> np.ndarray:
    """(2, hm, wm) normalized (dy, dx) offsets o(u) = M^-1(u) - u of the
    motion M prev -> current at the control points (float64)."""
    h, w = size
    hm, wm = field
    ys = np.arange(hm) * ((h - 1) / (hm - 1))
    xs = np.arange(wm) * ((w - 1) / (wm - 1))
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([gx, gy, np.ones_like(gx)], axis=-1)  # (hm, wm, 3)
    back = pts @ (np.linalg.inv(p_prev) @ p_cur).T  # M^-1 = P_prev^-1 P_cur
    sx, sy = back[..., 0] / back[..., 2], back[..., 1] / back[..., 2]
    return np.stack([(sy - gy) / (h - 1), (sx - gx) / (w - 1)])


class Smoother:
    """The trust ramp and the path smoother over a stream's inputs, one
    frame at a time; `correction(g)` is the field applied at input g (to
    input g - N)."""

    def __init__(self, settings: dict, size: tuple[int, int], inputs: Inputs, dtype: torch.dtype):
        self.s = settings
        self.sm = settings["smoother"]
        self.field = tuple(settings["tracker"]["motion_resolution"])
        self.size = size
        self.inputs = inputs
        self.dtype = dtype
        self.n = self.sm["predictive_samples"]
        self.window = 2 * self.n + 1
        self.positions: list[torch.Tensor] = []
        self.position = torch.zeros((2, *self.field), dtype=dtype)
        self.trust = torch.zeros((), dtype=dtype)
        self.smoothing = torch.ones((), dtype=dtype)
        self.drift_ema = torch.zeros((), dtype=dtype)
        self.done = 0
        self.wanted: set[int] = set()
        self.out: dict[int, torch.Tensor] = {}

    def _motion(self, g: int) -> torch.Tensor:
        if g == 0:  # no previous frame: the tracker reports no motion
            return torch.zeros((2, *self.field), dtype=self.dtype)
        r0, r1 = self.inputs.ring_index(g - 1), self.inputs.ring_index(g)
        m = true_motion(self.inputs.poses[r0], self.inputs.poses[r1], self.field, self.size)
        return torch.as_tensor(m, dtype=torch.float32).to(self.dtype)

    def _step(self, g: int) -> torch.Tensor:
        sm, dt = self.sm, self.dtype
        if g == 0:  # a tracking discontinuity drops the trust to 0
            self.trust = torch.zeros((), dtype=dt)
        else:
            self.trust = torch.clamp(self.trust + self.s["trust_step"], max=1.0)
        self.position = self.position + self._motion(g) * self.trust
        self.positions = (self.positions + [self.position])[-self.window:]
        count = len(self.positions)
        anchor = max(count - 1 - self.n, 0)
        sigma = sm["min_sigma"] + self.smoothing * (sm["max_sigma"] - sm["min_sigma"])
        idx = torch.arange(count, dtype=dt)
        wts = torch.exp(-0.5 * ((idx - anchor) / sigma) ** 2)
        wts = wts / torch.clamp(wts.sum(), min=1e-6)
        smoothed = torch.tensordot(wts, torch.stack(self.positions), dims=([0], [0]))
        raw = smoothed - self.positions[anchor]
        limit = sm["corrective_limit"]
        drift = raw.abs().max() / limit
        self.drift_ema = self.drift_ema + sm["response_rate"] * (drift - self.drift_ema)
        target = torch.where(self.drift_ema > sm["drift_high"], 0.0,
                             torch.where(self.drift_ema < sm["drift_low"], 1.0, self.smoothing))
        self.smoothing = self.smoothing + sm["response_rate"] * (target - self.smoothing)
        return torch.clamp(raw, -limit, limit)

    def correction(self, g: int) -> torch.Tensor:
        """The correction at input g (g >= N), computed in order; only
        those asked for ahead of time are kept (`want`)."""
        while self.done <= g:
            c = self._step(self.done)
            if self.done in self.wanted:
                self.out[self.done] = c
            self.done += 1
        return self.out[g]

    def want(self, gs) -> None:
        self.wanted = set(gs)


def corner_map(offsets: torch.Tensor, size: tuple[int, int], dtype, device) -> torch.Tensor:
    """(2, H, W) sample map of a 2 x 2 correction: the homography taking
    the corners onto the corners plus their offsets."""
    h, w = size
    off = offsets.double().cpu().numpy()
    dst = np.array([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]])  # (x, y)
    src = dst + np.stack([off[1].reshape(-1) * (w - 1), off[0].reshape(-1) * (h - 1)], axis=-1)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for k, ((x, y), (u, v)) in enumerate(zip(dst, src)):
        a[2 * k] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * k + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * k], b[2 * k + 1] = u, v
    m = np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)
    xx = torch.arange(w, device=device, dtype=dtype)[None, :]
    yy = torch.arange(h, device=device, dtype=dtype)[:, None]
    den = m[2, 0] * xx + m[2, 1] * yy + m[2, 2]
    return torch.stack([(m[1, 0] * xx + m[1, 1] * yy + m[1, 2]) / den,
                        (m[0, 0] * xx + m[0, 1] * yy + m[0, 2]) / den])


def mesh_map(offsets: torch.Tensor, size: tuple[int, int], dtype, device) -> torch.Tensor:
    """(2, H, W) sample map of a mesh correction: its offsets bilinearly
    interpolated over the corner-aligned grid, in pixels."""
    h, w = size
    off = F.interpolate(offsets.to(device=device, dtype=dtype)[None], size=(h, w), mode="bilinear",
                        align_corners=True)[0]
    yy = torch.arange(h, device=device, dtype=dtype)[:, None]
    xx = torch.arange(w, device=device, dtype=dtype)[None, :]
    return torch.stack([yy + off[0] * (h - 1), xx + off[1] * (w - 1)])


def sample_map(offsets: torch.Tensor, size, dtype, device) -> torch.Tensor:
    if tuple(offsets.shape[-2:]) == (2, 2):
        return corner_map(offsets, size, dtype, device)
    return mesh_map(offsets, size, dtype, device)


class Chain:
    """The reference of one stream through a configuration's chain: the
    stabilizer, whose warp filter is `reference/warps/<warp_filter>.py`,
    then each further filter by the `reference/filters/<type>.py` of its
    type."""

    def __init__(self, config: dict, inputs: Inputs, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        stab = config["filters"][0]
        if stab["type"] != "stabilization":
            raise ValueError("the reference chain starts with the stabilizer")
        settings = stab["settings"]
        if settings["crop_output"]:
            raise ValueError("the reference has no output crop")
        if settings["queue_dtype"] not in ("uint8", "float32"):
            raise ValueError(f"no reference for a {settings['queue_dtype']} queue")
        self.config = config
        self.size = tuple(config["size"])
        self.inputs = inputs
        self.dtype = dtype
        self.device = torch.device(device)
        self.u8 = settings["queue_dtype"] == "uint8"
        self.warp = importlib.import_module(f"reference.warps.{settings['warp_filter']}")
        self.filters = [(f["type"], importlib.import_module(f"reference.filters.{f['type']}"), f["settings"])
                        for f in config["filters"][1:]]
        self.smoother = Smoother(settings, self.size, inputs, dtype)
        self.delay = self.smoother.n

    def maps(self, gs) -> dict[int, torch.Tensor]:
        """The stabilizer's sample map at each input g of `gs`."""
        self.smoother.want(gs)
        return {g: sample_map(self.smoother.correction(g), self.size, self.dtype, self.device)
                for g in sorted(gs)}

    def output(self, g: int, smap: torch.Tensor) -> torch.Tensor:
        """The chain's output released by input g (showing input g - N),
        (3, H, W) YUV float32, from the stabilizer's map at g."""
        return self.stages(g, smap)[0]

    def stages(self, g: int, smap: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The output as `output`, and each further filter's change to the
        frame it was given ({type: (3, H, W) float32})."""
        dt = self.dtype
        src = self.inputs.frame(self.inputs.ring_index(g - self.delay)).to(self.device, dt)
        if self.u8:  # the 8-bit queue, warped on its levels and rounded back
            q = torch.clamp(src * 255.0 + 0.5, 0.0, 255.0).floor()
            px = torch.clamp(torch.round(self.warp.remap(q, smap.to(dt), fill=0.0)), 0.0, 255.0)
            px = px * (1.0 / 255.0)
        else:
            px = self.warp.remap(src, smap.to(dt), fill=0.0)
        changes = {}
        for kind, ref, settings in self.filters:
            out = ref.apply(px, settings)
            changes[kind] = (out - px).float()
            px = out
        return px.float(), changes


def bgr_inputs_to_yuv(frame_u8_hwc: np.ndarray, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """An 8-bit BGR (H, W, 3) input as the live drivers take it in: planar
    floats in [0, 1], converted to YUV."""
    t = torch.from_numpy(frame_u8_hwc).to(device)
    return color.bgr_to_yuv((t.to(dtype) * (1.0 / 255.0)).permute(2, 0, 1))
