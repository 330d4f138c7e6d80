"""The two-plane parallax cell of the benchmark (`vs1080_mesh_clip`) at a
small size on the CPU: the generator's two planes against the reference's
per-node truth, the port's Vector Field stabilizer judged plane by plane
against the two-plane reference (sound, and with the mesh solve held to its
global anchor), and the mesh solve's stages and counters in a traced
session.

The cell is cut as `benchmark/tests/tiny.py` cuts one, and further: a
270x480 frame, detection at half of it on the cell's 17x30 grid, the
cell's 16x16 mesh, a 32-frame ring, and regions 1 cell (not 1.5) clear of
the foreground's edge, since a cell of the mesh is a quarter of the cell's
own in pixels.  The shake is widened to 36 px (at 1080 rows; 9 px here) so
that the planes' motions differ by several pixels, as they do at 1080p."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH / "tests") not in sys.path:
    sys.path.insert(0, str(BENCH / "tests"))

from tiny import tiny_cell  # noqa: E402  (puts the benchmark on sys.path)

import faults_parallax  # noqa: E402
import run as bench  # noqa: E402
from harness import render, render_parallax  # noqa: E402
from harness.build import build_filter, pixel_format  # noqa: E402
from reference import parallax  # noqa: E402

from livevisionkit_tpu_torch.utils import profiling  # noqa: E402

SIZE, DETECTION = (270, 480), (136, 240)
SEED = 2**31 + 5


def _cell(**limits):
    cell = tiny_cell("vs1080_mesh_clip", size=SIZE, ring=32,
                     **{"clear_cells": 1.0, "min_region_px": 2000, "misalign_px": 1.2, "residual_u8": 2.0,
                        **limits})
    tracker = cell.config["filters"][0]["settings"]["tracker"]
    tracker["detection_size"] = list(DETECTION)
    tracker["detector"]["grid_shape"] = [17, 30]
    assert tracker["motion_resolution"] == [16, 16]
    cell.traffic["jitter_px"] = 36.0
    return cell


def _run(cell):
    return bench.execute(cell, seed=SEED, seconds=1.0, trace=False, device="cpu")


def test_two_plane_renderer_agrees_with_the_reference_truth():
    cell = _cell()
    size, field = tuple(cell.config["size"]), (16, 16)
    n = 6
    stream = render_parallax.make_stream(SEED, 0, n, size, cell.traffic, "cpu")
    bg_only = render.make_stream(SEED, 0, n, size, cell.traffic, "cpu")
    # The background is the one-plane generator's for the same seed.
    shown_bg = ~render_parallax.covered(stream.fg_poses, stream.fg_rect, size, "cpu")
    assert torch.equal(stream.frames[shown_bg.expand_as(stream.frames)],
                       bg_only.frames[shown_bg.expand_as(bg_only.frames)])
    inputs = parallax.PlaneInputs(poses=stream.path.poses, frame=lambda r: stream.frames[r],
                                  ring_index=lambda g: g, fg_poses=stream.fg_poses, fg_rect=stream.fg_rect)
    nodes = parallax.node_points(field, size)
    h, w = size
    ys, xs = np.meshgrid(np.arange(-3, 4), np.arange(-3, 4), indexing="ij")
    right, wrong = [], []
    for t in range(1, n):
        dist = parallax.edge_distance(stream.fg_poses[t], stream.fg_rect, field, size)
        # Which plane shows at a control point: the generator and the
        # reference agree wherever the point is not on the edge.
        iy, ix = np.round(nodes[..., 1]).astype(int), np.round(nodes[..., 0]).astype(int)
        shown_fg = render_parallax.covered(stream.fg_poses[t:t + 1], stream.fg_rect, size, "cpu")[0, 0]
        off_edge = np.abs(dist) > 0.1
        assert np.array_equal(shown_fg.numpy()[iy, ix][off_edge], (dist > 0)[off_edge])
        # A patch about each clear interior point of frame t is frame t - 1
        # at the point's true backward offset (from the plane that covers
        # it), and not at the other plane's.
        truth = parallax.plane_motion(inputs, t - 1, t, field, size)
        other = np.where(dist > 0,
                         parallax.true_motion(stream.path.poses[t - 1], stream.path.poses[t], field, size),
                         parallax.true_motion(stream.fg_poses[t - 1], stream.fg_poses[t], field, size))
        for i, j in zip(*np.nonzero((np.abs(dist) >= 1.0) & (iy >= 8) & (iy < h - 8) & (ix >= 8) & (ix < w - 8))):
            here = stream.frames[t, 0, iy[i, j] + ys, ix[i, j] + xs]
            for motion, errs in ((truth, right), (other, wrong)):
                sy, sx = iy[i, j] + ys + motion[0, i, j] * (h - 1), ix[i, j] + xs + motion[1, i, j] * (w - 1)
                grid = torch.tensor(np.stack([sx * 2 / (w - 1) - 1, sy * 2 / (h - 1) - 1], -1),
                                    dtype=torch.float32)[None]
                back = torch.nn.functional.grid_sample(stream.frames[t - 1:t, :1], grid, align_corners=True)
                errs.append(float((back[0, 0] - here).abs().mean()))
    assert len(right) > 100
    assert np.median(right) < 0.02 and np.median(wrong) > 3 * np.median(right)


def test_vector_field_passes_the_plane_judge():
    res = _run(_cell())
    assert res["correct"], res["checks"]
    checks = res["checks"]
    for plane in ("fg", "bg"):
        assert checks[f"region_px_{plane}"]["value"] >= 2000
        assert checks[f"misalign_{plane}_px"]["value"] <= checks["misalign_px"]["value"]


def test_mesh_held_to_its_global_anchor_fails_in_the_foreground(monkeypatch):
    faults_parallax.FAULTS["mesh_global_only"](monkeypatch.setattr)
    res = _run(_cell())
    assert not res["correct"]
    fg = res["checks"]["misalign_fg_px"]
    assert fg["value"] > fg["limit"], res["checks"]


def _clip_sessions():
    from livevisionkit_tpu_torch.runtime.offline import process_clip

    cell = _cell()
    size = tuple(cell.config["size"])
    frames = render_parallax.make_stream(SEED, 0, 4, size, cell.traffic, "cpu").frames
    filt, fmt = build_filter(cell.config), pixel_format(cell.config)
    process_clip(filt, frames, fmt, device="cpu")
    untraced = profiling.sessions()[-1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        process_clip(filt, frames, fmt, device="cpu")
    return cell, untraced, profiling.sessions()[-1], prof


def test_mesh_stages_and_counters_only_in_a_traced_session():
    cell, untraced, traced, prof = _clip_sessions()
    rounds = cell.config["filters"][0]["settings"]["tracker"]["mesh"]["irls_rounds"]
    assert (untraced.profiled, traced.profiled) == (False, True)
    assert not any(k.startswith("mesh.") for k in untraced.counters)
    c = traced.counters
    assert c["mesh.solves"] == 4
    assert 0 <= c["mesh.inliers"] <= c["mesh.matched"] and c["mesh.matched"] > 0
    assert c["mesh.local_dev_cpx"] >= 0
    # Every step enters each stage once a round (the set-up and the last
    # inliers once more), inside `tracker.mesh`, and the profiler records
    # each as a range of its name.
    spans = traced.spans
    assert spans["tracker.mesh"].n == 4
    assert spans["tracker.mesh.assemble"].n == 4 * (rounds + 2)
    assert spans["tracker.mesh.cg"].n == 4 * rounds
    assert spans["tracker.mesh.reweight"].n == 4 * (rounds + 1)
    assert all(k.startswith("tracker.mesh.") for k in spans["tracker.mesh"]._children[-1])
    ranges = {e.key: e.count for e in prof.key_averages()}
    assert ranges["tracker.mesh.cg"] == 4 * rounds and ranges["tracker.mesh.assemble"] == 4 * (rounds + 2)
    assert set(profiling.STAGES) >= {"tracker.mesh.assemble", "tracker.mesh.cg", "tracker.mesh.reweight"}


@pytest.mark.parametrize("traced", [False, True])
def test_mesh_stage_marks_only_while_tracing(traced, monkeypatch):
    """As on a card capturing a graph: while tracing, each mesh stage
    launches its marks inside `tracker.mesh`'s, in order; untraced, none."""
    from livevisionkit_tpu_torch.vision import frame_tracker

    marks = []

    class Library:
        def lvk_mark_stage(self, mark_id, stream):
            marks.append(mark_id)
            return 0

    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(profiling, "_marks", Library)
    if traced:
        monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)
    cell = _cell()
    filt = build_filter(cell.config)
    tracker = filt.settings.tracker
    state = frame_tracker.init(tracker, device="cpu")
    frames = render_parallax.make_stream(SEED, 0, 2, SIZE, cell.traffic, "cpu").frames
    for t in range(2):
        state, _ = frame_tracker.track(state, frames[t, 0], tracker)
    names = [profiling.stage_of_kernel(f"lvk_stage_mark<{i}>") for i in marks]
    if not traced:
        assert names == []
        return
    mesh = [n for n in names if n[0].startswith("tracker.mesh")]

    def stage(name):
        return [(f"tracker.mesh.{name}", False), (f"tracker.mesh.{name}", True)]

    rounds = tracker.mesh.irls_rounds
    per_step = ([("tracker.mesh", False)] + stage("assemble") * 2
                + (stage("assemble") + stage("cg") + stage("reweight")) * rounds
                + stage("reweight") + [("tracker.mesh", True)])
    assert mesh == per_step * 2
