"""The traffic generator: shaky camera paths over a seeded texture, rendered
on the card with plain PyTorch (`F.grid_sample`), with the true pose of
every frame kept for the reference.

A path is closed over its ring of frames (a slow periodic drift plus
per-frame jitter in translation and angle), so a driver that plays the
ring again sees the wrap as one more shake.  Every size and every count
comes from the traffic file and the frame size; the seed changes only the
texture and the path, never the work."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

def stream_seed(seed: int, stream: int) -> np.random.SeedSequence:
    """The seed sequence of one stream of a run (any whole `seed`)."""
    return np.random.SeedSequence([seed % 2**64, stream])


@dataclass(frozen=True)
class Path:
    """A closed camera path: `poses[t]` maps frame pixel (x, y, 1) to the
    texture (float64, (T, 3, 3))."""

    poses: np.ndarray
    margin: int  # texture border beyond the frame on each side, pixels


def camera_path(rng: np.random.Generator, n: int, size: tuple[int, int], traffic: dict) -> Path:
    """n poses: drift of `drift_px` (at 1080 rows; scaled with the height)
    around a circle once over the ring, jitter of +/- `jitter_px` and
    +/- `jitter_rad` a frame."""
    h, _ = size
    s = h / 1080.0
    drift, jit, jit_rad = traffic["drift_px"] * s, traffic["jitter_px"] * s, traffic["jitter_rad"]
    margin = int(math.ceil(traffic["margin_px"] * s))
    phase = 2.0 * math.pi * np.arange(n) / n
    tx = margin + drift * (1.0 - np.cos(phase)) / 2.0 + rng.uniform(-jit, jit, n)
    ty = margin + drift * np.sin(phase) / 2.0 + rng.uniform(-jit, jit, n)
    ang = 0.5 * traffic["jitter_rad"] * np.sin(phase) + rng.uniform(-jit_rad, jit_rad, n)
    c, si = np.cos(ang), np.sin(ang)
    poses = np.zeros((n, 3, 3))
    poses[:, 0, 0], poses[:, 0, 1], poses[:, 0, 2] = c, -si, tx
    poses[:, 1, 0], poses[:, 1, 1], poses[:, 1, 2] = si, c, ty
    poses[:, 2, 2] = 1.0
    return Path(poses=poses, margin=margin)


def texture(gen: torch.Generator, size: tuple[int, int], device) -> torch.Tensor:
    """A (3, h, w) YUV texture in [0, 1]: blurred noise under a grid of
    bright and dark squares (one in each 50 x 50 cell, 12-47 pixels wide),
    each square with a colour of its own over smooth chroma."""
    h, w = size
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    base = 0.2 + 0.3 * rand(1, 1, h, w)
    cross = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]], device=device) / 5.0
    for _ in range(2):
        base = F.conv2d(F.pad(base, (1, 1, 1, 1), mode="circular"), cross[None, None])
    cell = 50
    ch, cw = -(-h // cell), -(-w // cell)
    side = 12 + torch.floor(36 * rand(ch, cw))
    oy, ox = torch.floor((cell - side) * rand(ch, cw)), torch.floor((cell - side) * rand(ch, cw))
    bright = rand(ch, cw) > 0.5
    level = torch.where(bright, 0.75 + 0.25 * rand(ch, cw), 0.1 * rand(ch, cw))
    tint = 0.2 * (rand(2, ch, cw) - 0.5)
    yy = torch.arange(h, device=device)
    xx = torch.arange(w, device=device)
    cy, cx = yy // cell, xx // cell
    ry = (yy % cell).float()[:, None] - oy[cy][:, cx]
    rx = (xx % cell).float()[None, :] - ox[cy][:, cx]
    s = side[cy][:, cx]
    inside = (ry >= 0) & (ry < s) & (rx >= 0) & (rx < s)
    luma = torch.where(inside, level[cy][:, cx], base[0, 0])
    chroma = 0.5 + 0.3 * (F.interpolate(rand(1, 2, ch, cw), size=(h, w), mode="bicubic",
                                         align_corners=False)[0] - 0.5)
    chroma = torch.where(inside, 0.5 + tint[:, cy][:, :, cx], chroma)
    return torch.cat([luma[None], chroma.clamp(0.0, 1.0)])


def render(tex: torch.Tensor, poses: np.ndarray, size: tuple[int, int], batch: int = 8) -> torch.Tensor:
    """(T, C, h, w) frames: frame t samples the texture at poses[t](u),
    bilinear (`F.grid_sample`, border clamp)."""
    h, w = size
    c, th, tw = tex.shape
    dev = tex.device
    out = torch.empty((len(poses), c, h, w), dtype=torch.float32, device=dev)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    for t0 in range(0, len(poses), batch):
        m = torch.as_tensor(poses[t0:t0 + batch], dtype=torch.float32, device=dev)
        b = m.shape[0]
        sx = m[:, 0, 0, None, None] * xx + m[:, 0, 1, None, None] * yy + m[:, 0, 2, None, None]
        sy = m[:, 1, 0, None, None] * xx + m[:, 1, 1, None, None] * yy + m[:, 1, 2, None, None]
        grid = torch.stack([sx * (2.0 / (tw - 1)) - 1.0, sy * (2.0 / (th - 1)) - 1.0], dim=-1)
        out[t0:t0 + b] = F.grid_sample(tex[None].expand(b, c, th, tw), grid, mode="bilinear",
                                       padding_mode="border", align_corners=True)
    return out


def staircase(tex: torch.Tensor, block: int, step_levels: int) -> torch.Tensor:
    """Block-coded content in the scene, in place: right of two thirds
    across (on a block boundary) the texture's luma becomes a horizontal
    staircase of `block`-wide flat steps `step_levels` 8-bit levels apart,
    as block-coded video decodes a smooth gradient.  It moves with the
    camera like the rest of the scene."""
    w = tex.shape[-1]
    x0 = (2 * w // 3) // block * block
    steps = torch.div(torch.arange(w - x0, device=tex.device), block, rounding_mode="floor")
    tex[0, :, x0:] = (51.0 + step_levels * steps.to(torch.float32)) / 255.0
    return tex


def quantize(frames: torch.Tensor) -> torch.Tensor:
    """Round to the 8-bit grid, in place; values stay float."""
    return frames.mul_(255.0).add_(0.5).clamp_(0.0, 255.0).floor_().mul_(1.0 / 255.0)


@dataclass
class Stream:
    """One stream's ring: its path and frames (device)."""

    path: Path
    frames: torch.Tensor  # (T, 3, h, w) float32 YUV in [0, 1]


def make_stream(seed: int, stream: int, n: int, size: tuple[int, int], traffic: dict, device) -> Stream:
    """The ring of stream `stream` of a run seeded `seed`."""
    seq = stream_seed(seed, stream)
    rng = np.random.default_rng(seq)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
    path = camera_path(rng, n, size, traffic)
    h, w = size
    tex = texture(gen, (h + 2 * path.margin, w + 2 * path.margin), device)
    if traffic["content"] == "block_coded":
        staircase(tex, traffic["block_px"], traffic["step_levels"])
    frames = render(tex, path.poses, size)
    del tex
    if traffic["content"] == "block_coded":
        quantize(frames)  # decoded video: every plane on the 8-bit grid
    return Stream(path=path, frames=frames)


def ring_frames(traffic: dict, size: tuple[int, int]) -> int:
    """Frames of a ring: `ring_frames`, or `ring_frames_at_1080p` scaled by
    the frame area (a clip holding the same bytes at any size)."""
    if "ring_frames" in traffic:
        return int(traffic["ring_frames"])
    h, w = size
    return max(1, round(traffic["ring_frames_at_1080p"] * 1080 * 1920 / (h * w)))
