"""The plain reference of a stabilizer over a two-plane scene: a background
and a nearer foreground rectangle that occludes it, each along its own true
path.

The chain is `reference.stabilizer`'s (the trust ramp, the smoother and
its servo, the mesh map, the warp filter), worked out from each control
point's true motion prev -> current, taken from the plane that covers the
point in the current frame: inside the foreground's footprint the
foreground's, elsewhere the background's.  Near the footprint's edge no
one motion is the truth (a mesh is smooth, the scene is not), so the
comparison is made only inside each plane's clear region: the pixels of
the mesh cells whose four control points lie at least `clear_cells` cells
(in each axis's own cell size) from the footprint's edge, on the same
side, in every frame that enters the output (its smoother window, which
holds the frame it shows).

Nothing here imports the program or the generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference.stabilizer import Chain, Inputs, Smoother, true_motion


@dataclass
class PlaneInputs(Inputs):
    """`Inputs` of a two-plane stream: `poses` are the background's;
    `fg_poses[r]` maps frame pixel (x, y, 1) of ring frame r to the
    foreground's texture, of which the rectangle `fg_rect` (x0, y0, x1, y1)
    is all that shows."""

    fg_poses: np.ndarray
    fg_rect: tuple


def node_points(field: tuple[int, int], size: tuple[int, int]) -> np.ndarray:
    """(hm, wm, 2) (x, y) pixel positions of the corner-aligned control
    points."""
    h, w = size
    hm, wm = field
    gy, gx = np.meshgrid(np.arange(hm) * ((h - 1) / (hm - 1)), np.arange(wm) * ((w - 1) / (wm - 1)),
                         indexing="ij")
    return np.stack([gx, gy], axis=-1)


def footprint(pose: np.ndarray, rect: tuple) -> np.ndarray:
    """(4, 2) frame-pixel corners of the foreground's rectangle, in order
    around it."""
    x0, y0, x1, y1 = rect
    corners = np.array([[x0, y0, 1.0], [x1, y0, 1.0], [x1, y1, 1.0], [x0, y1, 1.0]])
    back = corners @ np.linalg.inv(pose).T
    return back[:, :2] / back[:, 2:]


def edge_distance(pose: np.ndarray, rect: tuple, field: tuple[int, int], size: tuple[int, int]) -> np.ndarray:
    """(hm, wm) each control point's distance to the foreground footprint's
    edge, in cells (x over the cell's width, y over its height): positive
    inside the footprint, negative outside."""
    h, w = size
    hm, wm = field
    cell = np.array([(w - 1) / (wm - 1), (h - 1) / (hm - 1)])
    quad = footprint(pose, rect) / cell  # a convex quad, in cells
    pts = node_points(field, size) / cell
    dist = np.full((hm, wm), np.inf)
    sides = []
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        ab = b - a
        ap = pts - a
        t = np.clip((ap @ ab) / (ab @ ab), 0.0, 1.0)
        dist = np.minimum(dist, np.linalg.norm(ap - t[..., None] * ab, axis=-1))
        sides.append(ab[0] * ap[..., 1] - ab[1] * ap[..., 0])
    sides = np.stack(sides)
    inside = np.all(sides >= 0, axis=0) | np.all(sides <= 0, axis=0)
    return np.where(inside, dist, -dist)


def plane_motion(inputs: PlaneInputs, r0: int, r1: int, field: tuple[int, int],
                 size: tuple[int, int]) -> np.ndarray:
    """(2, hm, wm) normalized backward offsets of the motion ring frame r0 ->
    r1 at the control points, each from the plane that covers it in r1."""
    bg = true_motion(inputs.poses[r0], inputs.poses[r1], field, size)
    fg = true_motion(inputs.fg_poses[r0], inputs.fg_poses[r1], field, size)
    return np.where(edge_distance(inputs.fg_poses[r1], inputs.fg_rect, field, size) > 0, fg, bg)


class PlaneSmoother(Smoother):
    """The reference's trust ramp and smoother over each control point's
    true motion, from the plane that covers it."""

    def _motion(self, g: int) -> torch.Tensor:
        if g == 0:
            return torch.zeros((2, *self.field), dtype=self.dtype)
        r0, r1 = self.inputs.ring_index(g - 1), self.inputs.ring_index(g)
        m = plane_motion(self.inputs, r0, r1, self.field, self.size)
        return torch.as_tensor(m, dtype=torch.float32).to(self.dtype)


class PlaneChain(Chain):
    """`Chain` over a two-plane stream: a mesh stabilizer (a 2 x 2 field has
    no per-plane motion) and no further filter."""

    def __init__(self, config: dict, inputs: PlaneInputs, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        super().__init__(config, inputs, dtype, device)
        settings = config["filters"][0]["settings"]
        if tuple(settings["tracker"]["motion_resolution"]) == (2, 2) or self.filters:
            raise ValueError("the two-plane reference is a mesh stabilizer alone")
        self.smoother = PlaneSmoother(settings, self.size, inputs, dtype)

    def regions(self, g: int, clear_cells: float, margin: int) -> dict[str, torch.Tensor]:
        """{"fg", "bg"}: (H, W) bool, each plane's clear region in the output
        released by input g, inside `margin` pixels of the frame's edge."""
        h, w = self.size
        field = self.smoother.field
        hm, wm = field
        frames = [self.inputs.ring_index(k) for k in range(max(0, g - 2 * self.delay), g + 1)]
        dist = np.stack([edge_distance(self.inputs.fg_poses[r], self.inputs.fg_rect, field, self.size)
                         for r in frames])
        nodes = {"fg": dist.min(axis=0) >= clear_cells, "bg": dist.max(axis=0) <= -clear_cells}
        iy = np.minimum((np.arange(h) * ((hm - 1) / (h - 1))).astype(np.int64), hm - 2)
        ix = np.minimum((np.arange(w) * ((wm - 1) / (w - 1))).astype(np.int64), wm - 2)
        interior = np.zeros((h, w), dtype=bool)
        interior[margin:h - margin, margin:w - margin] = True
        out = {}
        for plane, ok in nodes.items():
            cells = ok[:-1, :-1] & ok[1:, :-1] & ok[:-1, 1:] & ok[1:, 1:]
            out[plane] = torch.from_numpy(cells[iy][:, ix] & interior).to(self.device)
        return out
