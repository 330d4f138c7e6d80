"""A two-plane parallax fixture for mesh mode: matched features where the
background moves by one homography and a foreground rectangle by another,
so the per-node motion has a known, local ground truth (a mesh that only
collapses to one homography cannot pass).  The same features go through
the JAX package's `vision/mesh_motion.estimate` and the port's: the port
within the mesh parity bound of tests/test_torch_mesh.py (1e-3 detection
px on every node), and both recovering the ground truth at the nodes away
from the planes' boundary."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.models import warp_field as jwf
from livevisionkit_tpu.vision import mesh_motion as jmm
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.models import warp_field as twf
from livevisionkit_tpu_torch.vision import mesh_motion as tmm

SIZE, MESH = (272, 480), (16, 16)  # the flagship's detection size, the field preset's mesh
FG = (150.0, 80.0, 330.0, 200.0)  # the foreground rectangle, x0, y0, x1, y1 (px)
N_FEATURES = 1500
# Nodes whose distance to the rectangle's edge exceeds this many cells of
# the mesh hold one plane's motion alone.
CLEAR_CELLS = 1.5
GT_BOUND_PX = 0.25  # recovery bound at those nodes, both packages
PARITY_PX = 1e-3  # the port against JAX, every node


def _homography(scale, angle, tx, ty, px=0.0, py=0.0) -> np.ndarray:
    """A similarity about the frame's centre with a perspective row."""
    h, w = SIZE
    c, s = scale * np.cos(angle), scale * np.sin(angle)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    centre = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    back = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]])
    m = back @ np.array([[c, -s, 0], [s, c, 0], [px, py, 1]]) @ centre
    return m / m[2, 2]


# Backward maps (a current-frame point -> its previous-frame point): the
# background pans and turns slightly, the foreground, nearer the camera,
# moves more and grows.
H_BG = _homography(1.0, 0.004, 3.0, -2.0, 2e-6, -1e-6)
H_FG = _homography(1.02, -0.01, -5.0, 4.0)


def _apply(m, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ m.T
    return p[:, :2] / p[:, 2:]


def _in_fg(pts):
    x0, y0, x1, y1 = FG
    return (pts[:, 0] >= x0) & (pts[:, 0] < x1) & (pts[:, 1] >= y0) & (pts[:, 1] < y1)


def _nodes():
    """(nodes, 2) (x, y) px of the mesh nodes, corner-aligned over the frame."""
    h, w = SIZE
    hm, wm = MESH
    yy, xx = np.meshgrid(np.linspace(0, h - 1, hm), np.linspace(0, w - 1, wm), indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def _offsets(pts, fg):
    """(2, Hm, Wm) normalized (dy, dx) backward offsets of the nodes `pts`,
    each by its plane's homography."""
    h, w = SIZE
    d = np.where(fg[:, None], _apply(H_FG, pts), _apply(H_BG, pts)) - pts
    return np.stack([d[:, 1] / (h - 1), d[:, 0] / (w - 1)]).reshape(2, *MESH).astype(np.float32)


@functools.cache
def _fixture(seed=0):
    """(src, dst, weights) of the matched features, the global fit (the
    background plane's field, as RANSAC would give it), the per-node
    ground truth and the mask of nodes clear of the boundary."""
    h, w = SIZE
    rng = np.random.default_rng(seed)
    dst = np.stack([rng.uniform(2, w - 3, N_FEATURES), rng.uniform(2, h - 3, N_FEATURES)], -1)
    src = np.where(_in_fg(dst)[:, None], _apply(H_FG, dst), _apply(H_BG, dst))
    nodes = _nodes()
    fg = _in_fg(nodes)
    x0, y0, x1, y1 = FG
    cell_x, cell_y = (w - 1) / (MESH[1] - 1), (h - 1) / (MESH[0] - 1)
    # Distance to the rectangle's edge, in cells, along each axis.
    dx = np.minimum(np.abs(nodes[:, 0] - x0), np.abs(nodes[:, 0] - x1)) / cell_x
    dy = np.minimum(np.abs(nodes[:, 1] - y0), np.abs(nodes[:, 1] - y1)) / cell_y
    inside_x = (nodes[:, 0] > x0) & (nodes[:, 0] < x1)
    inside_y = (nodes[:, 1] > y0) & (nodes[:, 1] < y1)
    near = ((dx < CLEAR_CELLS) & (dy < CLEAR_CELLS)) | ((dx < CLEAR_CELLS) & inside_y) | (
        (dy < CLEAR_CELLS) & inside_x)
    return (src.astype(np.float32), dst.astype(np.float32), np.ones(N_FEATURES, np.float32),
            _offsets(nodes, np.zeros(len(nodes), bool)), _offsets(nodes, fg),
            (~near).reshape(MESH), fg.reshape(MESH))


def _settings(cfg):
    """The field preset's solve (presets.vector_field_preset: a 10 px
    inlier threshold; the other knobs at their defaults)."""
    return cfg.MeshMotionSettings(inlier_threshold_px=10.0)


@functools.cache
def _solves():
    src, dst, wts, glob, _, _, _ = _fixture()
    fj = jax.jit(jmm.estimate, static_argnums=(4, 5))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wts), jwf.WarpField(offsets=jnp.asarray(glob)),
        SIZE, _settings(jcfg))
    ft = tmm.estimate(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(wts),
                      twf.WarpField(offsets=torch.from_numpy(glob)), SIZE, _settings(tcfg))
    return np.asarray(fj[0].offsets), ft[0].offsets.numpy()


def _px(offsets):
    h, w = SIZE
    return offsets * np.array([h - 1, w - 1], np.float32).reshape(2, 1, 1)


def test_fixture_has_two_planes_and_clear_nodes():
    """The planes differ by several px at the nodes, and both keep nodes
    clear of their boundary."""
    _, _, _, glob, gt, clear, fg = _fixture()
    gap = np.abs(_px(gt - glob)).max(axis=0)
    assert gap[fg].min() > 3.0 and gap[~fg].max() == 0.0
    assert (clear & fg).sum() >= 6 and (clear & ~fg).sum() >= 100


def test_port_matches_jax_on_two_planes():
    oj, ot = _solves()
    err = np.abs(_px(ot - oj)).max()
    assert err <= PARITY_PX, f"port vs JAX: {err:.2e} px"


def test_both_recover_each_plane_away_from_the_boundary():
    """Per-node error against the ground truth below GT_BOUND_PX at every
    node clear of the boundary, in each plane, for both packages."""
    _, _, _, _, gt, clear, fg = _fixture()
    for name, off in zip(("jax", "port"), _solves()):
        err = np.abs(_px(off - gt)).max(axis=0)
        for plane, mask in (("foreground", clear & fg), ("background", clear & ~fg)):
            worst = err[mask].max()
            assert worst < GT_BOUND_PX, f"{name} {plane}: {worst:.3f} px"
