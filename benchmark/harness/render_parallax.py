"""The two-plane traffic generator: the background of `render` (the same
seeded texture along the same closed camera path) and a nearer plane in
front of it, rendered on the card with plain PyTorch, with both planes'
true poses kept for the reference.

The foreground is a rectangle of its own seeded texture: where it rests
(no drift, no jitter) it covers `foreground_x` and `foreground_y` of the
frame (shares of its width and height).  Being nearer the camera, its
image moves about the frame's centre by `parallax_factor` times the
background's displacement of the centre and times the background's angle,
and its scale jitters by +/- `scale_jitter` a frame.  It occludes the
background: a pixel whose pose falls inside the rectangle shows the
foreground, every other pixel the background."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from harness import render


def foreground_rect(traffic: dict, size: tuple[int, int], margin: int) -> tuple[float, float, float, float]:
    """(x0, y0, x1, y1): the foreground's rectangle on its texture, whose
    pixel u + margin shows at frame pixel u where the plane rests."""
    h, w = size
    (fx0, fx1), (fy0, fy1) = traffic["foreground_x"], traffic["foreground_y"]
    return (fx0 * w + margin, fy0 * h + margin, fx1 * w + margin, fy1 * h + margin)


def foreground_poses(bg: render.Path, rng: np.random.Generator, size: tuple[int, int],
                     traffic: dict) -> np.ndarray:
    """(T, 3, 3) poses mapping frame pixel (x, y, 1) to the foreground's
    texture: about the frame's centre c, the background's displacement of
    c and its angle, each times `parallax_factor`, and a scale of
    1 +/- `scale_jitter` drawn a frame."""
    h, w = size
    k = traffic["parallax_factor"]
    n = len(bg.poses)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    lin_bg, t_bg = bg.poses[:, :2, :2], bg.poses[:, :2, 2]
    angle = np.arctan2(lin_bg[:, 1, 0], lin_bg[:, 0, 0])
    shift = lin_bg @ c + t_bg - c - bg.margin  # the background's displacement of c from rest
    scale = 1.0 + rng.uniform(-traffic["scale_jitter"], traffic["scale_jitter"], n)
    cos, sin = scale * np.cos(k * angle), scale * np.sin(k * angle)
    poses = np.zeros((n, 3, 3))
    poses[:, 0, 0], poses[:, 0, 1], poses[:, 1, 0], poses[:, 1, 1] = cos, -sin, sin, cos
    poses[:, :2, 2] = c + bg.margin + k * shift - poses[:, :2, :2] @ c
    poses[:, 2, 2] = 1.0
    return poses


def covered(poses: np.ndarray, rect: tuple, size: tuple[int, int], device) -> torch.Tensor:
    """(T, 1, h, w) bool: the pixels of each frame that show the foreground."""
    h, w = size
    x0, y0, x1, y1 = rect
    m = torch.as_tensor(poses, dtype=torch.float32, device=device)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    sx = m[:, 0, 0, None, None] * xx + m[:, 0, 1, None, None] * yy + m[:, 0, 2, None, None]
    sy = m[:, 1, 0, None, None] * xx + m[:, 1, 1, None, None] * yy + m[:, 1, 2, None, None]
    return ((sx >= x0) & (sx < x1) & (sy >= y0) & (sy < y1))[:, None]


@dataclass
class Stream(render.Stream):
    """One two-plane stream's ring: `path` is the background's, `fg_poses`
    the foreground's, `fg_rect` its rectangle on its texture."""

    fg_poses: np.ndarray
    fg_rect: tuple


def make_stream(seed: int, stream: int, n: int, size: tuple[int, int], traffic: dict, device,
                batch: int = 8) -> Stream:
    """The ring of stream `stream` of a run seeded `seed`: its background is
    `render.make_stream`'s for the same seed (drawn first, from the same
    generators), its foreground drawn after it."""
    seq = render.stream_seed(seed, stream)
    rng = np.random.default_rng(seq)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
    path = render.camera_path(rng, n, size, traffic)
    fg_poses = foreground_poses(path, rng, size, traffic)
    h, w = size
    tex_size = (h + 2 * path.margin, w + 2 * path.margin)
    bg_tex = render.texture(gen, tex_size, device)
    fg_tex = render.texture(gen, tex_size, device)
    rect = foreground_rect(traffic, size, path.margin)
    frames = torch.empty((n, 3, h, w), dtype=torch.float32, device=device)
    for t0 in range(0, n, batch):
        sl = slice(t0, t0 + batch)
        bg = render.render(bg_tex, path.poses[sl], size)
        fg = render.render(fg_tex, fg_poses[sl], size)
        frames[sl] = torch.where(covered(fg_poses[sl], rect, size, device), fg, bg)
        del bg, fg
    del bg_tex, fg_tex
    return Stream(path=path, frames=frames, fg_poses=fg_poses, fg_rect=rect)
