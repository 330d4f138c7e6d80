"""The port's bench and profiling tools on the CPU at small sizes
(bench_torch.py, tools/bench_matrix_torch.py, tools/profile_stages_torch.py,
tools/profile_tracker_torch.py, tools/profile_enhance_torch.py,
tools/profile_serving_stages_torch.py): each prints the JAX tool's rows
under its names (read from the JAX tool's source as text, never
imported), bench_torch's line has bench.py's keys, `graph_time` gives a
finite positive time, every profiled body returns what the port function
it times returns when called directly on the same seeded input, and
--json-out refuses the JAX package's BENCH_* records.  Each test takes a
few seconds here; none is `slow`."""

import ast
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys

import pytest
import torch
import torch.utils._pytree as pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import bench_matrix_torch as bmt  # noqa: E402
import bench_torch  # noqa: E402
import profile_enhance_torch as pe  # noqa: E402
import profile_serving_stages_torch as pss  # noqa: E402
import profile_stages_torch as ps  # noqa: E402
import profile_tracker_torch as pt  # noqa: E402

import livevisionkit_tpu_torch as lt  # noqa: E402
from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer  # noqa: E402
from livevisionkit_tpu_torch.ops import color, easu, rcas, resample  # noqa: E402
from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter  # noqa: E402
from livevisionkit_tpu_torch.vision import (  # noqa: E402
    features,
    frame_tracker,
    mesh_motion,
    optical_flow,
    path_smoother,
    ransac,
)
from serving_torch import serving_filter  # noqa: E402

SIZE = (96, 128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as fh:
        return fh.read()


def _jax_rows(rel: str) -> list[str]:
    """The row names a JAX tool prints: the text before the colon of each
    `print(f"NAME: {scan_time(...)` line, and the names of its
    `t("NAME", ...)` rows."""
    src = _source(rel)
    names = re.findall(r'print\(f"(.+?):\s*\{scan_time\b', src)
    names += re.findall(r'\bt\("([^"]+)"', src)
    return [n.strip() for n in names]


def _names(gen) -> list[str]:
    return [name.strip() for name, _, _ in gen]


def _zero():
    return torch.zeros((), dtype=torch.float32)


def _assert_same(got, want, what):
    got_l, want_l = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for a, b in zip(got_l, want_l):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"{what}: differs from the direct call"


# ------------------------------------------------------------------ names

def test_profile_stages_rows_are_the_jax_tools():
    want = _jax_rows("tools/profile_stages.py")
    assert want == ["full step", "tracker.track", "luma+detect resize", "warp.apply 1080p",
                    "smoother", "features.detect"]
    assert _names(ps.bodies(serving_filter(SIZE), SIZE, "cpu")) == want


@pytest.mark.parametrize("mesh", [False, True])
def test_profile_tracker_rows_are_the_jax_tools(mesh):
    """The mesh row, last, under the JAX tool's condition (a field other
    than 2x2)."""
    want = _jax_rows("tools/profile_tracker.py")
    assert want[-1] == "mesh_motion.estimate" and len(want) == 6
    got = _names(pt.bodies(pt.settings_for(SIZE, mesh), 1, SIZE, "cpu"))
    assert got == (want if mesh else want[:-1])
    assert "motion_resolution=(2, 2)" in pt.header(pt.settings_for(SIZE), 1)


def test_profile_enhance_rows_are_the_jax_tools():
    want = _jax_rows("tools/profile_enhance.py")
    assert len(want) == 8 and want[5] == "easu_scale 1080p->4K"
    assert _names(pe.bodies(SIZE, "cpu")) == want


def test_profile_serving_stages_rows_are_the_jax_tools():
    """The JAX tool's f-string fields: the warp filter (a loop over easu
    and bilinear) and S."""
    tmpl = re.findall(r'print\(f"(.+?):\s*\{ms\b', _source("tools/profile_serving_stages.py"))
    want = [tmpl[0].format(wf=wf) for wf in ("easu", "bilinear")]
    want += [t.format(S=2) for t in tmpl[1:]]
    assert want == ["full step (easu    )", "full step (bilinear)", "tracker.track (S=2)",
                    "queue quant/push/deq "]
    assert [n for n, _, _ in pss.bodies(2, SIZE, "cpu")] == want


def test_bench_matrix_configs_are_the_jax_tools():
    want = re.findall(r'\brun\(\s*"([^"]+)"', _source("tools/bench_matrix.py"))
    assert len(want) == 14
    cfgs = bmt.configs()
    assert [c[0] for c in cfgs] == want
    sizes = {name: (c, h, w) for name, _, c, h, w, _ in cfgs}
    assert sizes["640x480_gray_stabilization"] == (1, 480, 640)
    assert all(sizes[n] == (3, 2160, 3840) for n in want if n.startswith("4k_"))
    assert all(sizes[n] == (3, 1080, 1920) for n in want if n.startswith("1080p"))
    gray = cfgs[0][1].settings
    assert (gray.tracker.detection_size, gray.tracker.detector.grid_shape,
            gray.tracker.min_motion_samples, gray.tracker.motion.hypotheses) == (
        (240, 320), (12, 16), 30, 128)
    assert [f.name for f in cfgs[-1][1].filters] == ["StabilizationFilter", "DeblockingFilter",
                                                      "CASFilter"]


def test_bench_line_has_bench_py_keys():
    """One JSON line on stdout with exactly bench.py's keys."""
    tree = ast.parse(_source("bench.py"))
    keys = [{k.value for k in node.keys} for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and node.keys and all(isinstance(k, ast.Constant) for k in node.keys)]
    assert keys == [{"metric", "value", "unit", "vs_baseline"}]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench_torch.main(["--device", "cpu", "--size", "96x128", "--n", "1", "--reps", "1"])
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(printed) == keys[0] and printed == line
    assert printed["metric"] == "1080p_stabilization_latency"
    assert math.isclose(printed["vs_baseline"], 8.0 / printed["value"])


# ------------------------------------------------------------- graph_time

@pytest.mark.parametrize("stat", ["min", "median"])
def test_graph_time_is_finite_and_positive_on_the_cpu(stat):
    x = torch.ones(64, 64)

    def body(c, t):
        return c + 1.0, (x + t).sum()

    ms = ps.graph_time(body, _zero(), n=3, reps=2, stat=stat)
    assert math.isfinite(ms) and ms > 0
    with pytest.raises(ValueError):
        ps.graph_time(body, _zero(), n=1, reps=1, stat="mean")


def test_graph_time_advances_the_step_counter():
    """Every call sees the next t (0, 1, 2, ...): the warm-up call and then
    reps x n timed calls."""
    seen = []

    def body(c, t):
        seen.append(float(t))
        return c, t

    ps.graph_time(body, _zero(), n=3, reps=2)
    assert seen == [float(k) for k in range(7)]


# ----------------------------------------------- bodies against direct calls

def test_profile_stages_bodies_return_the_direct_calls():
    filt = serving_filter(SIZE)
    s = filt.settings
    pix = ps.noise((3, *SIZE))
    luma = pix[0]
    det = s.tracker.detection_size
    res = s.tracker.motion_resolution
    frame = lt.Frame.create(pix, timestamp=0.0, fmt=lt.PixelFormat.YUV)
    g = resample.resize(luma, det)
    direct = {
        "full step": lambda: filt.step(filt.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV),
                                                 device="cpu"), frame),
        "tracker.track": lambda: (lambda r: (r[0], (r[1].motion.offsets, r[1].stability)))(
            frame_tracker.track(frame_tracker.init(s.tracker, device="cpu"), luma, s.tracker)),
        "luma+detect resize": lambda: (_zero(), resample.resize(luma, det)),
        "warp.apply 1080p": lambda: (_zero(), lt.WarpField(
            offsets=lt.WarpField.identity(res, device="cpu").offsets + 0.01).apply(pix, fill=0.0)),
        "smoother": lambda: (lambda r: (r[0], r[1].offsets))(path_smoother.next_correction(
            path_smoother.init(s.smoother, res, device="cpu"),
            lt.WarpField.identity(res, device="cpu"), s.smoother)),
        "features.detect": lambda: (lambda r: (_zero(), (r[0].points, r[0].valid, r[1])))(
            features.detect(g, features.initial_thresholds(s.tracker.detector, device="cpu"),
                            s.tracker.detector)),
    }
    for name, body, state in ps.bodies(filt, SIZE, "cpu"):
        _assert_same(body(state, _zero()), direct[name](), name)


@pytest.mark.parametrize("mesh", [False, True])
def test_profile_tracker_bodies_return_the_direct_calls(mesh):
    """S = 1: each body against the solo call on a tracker state seeded by
    two tracks, called in the tool's order so that the two RANSAC
    generators (one each side, both seeded 0) draw in step."""
    s = pt.settings_for(SIZE, mesh)
    det_size, levels = tuple(s.detection_size), s.flow.pyramid_levels
    gray = ps.noise(SIZE)
    st = frame_tracker.init(s, device="cpu")
    for _ in range(2):
        st, _ = frame_tracker.track(st, gray, s)
    det = resample.resize(gray, det_size, antialias=True)
    pyr = optical_flow.Pyramid.build(det, levels)
    dst = st.features.points + 0.5

    def track():
        _, r = frame_tracker.track(st, gray, s)
        return r.motion.offsets, r.stability

    def est():
        e = ransac.estimate(st.features.points, dst, st.features.valid, st.generator, s.motion,
                            use_homography=torch.ones((), dtype=torch.bool),
                            min_samples=s.min_motion_samples)
        return e.homography.m, e.stability

    def detect():
        fs, thr = features.detect(det, st.thresholds, s.detector)
        return fs.points, fs.valid, thr

    direct = {
        "track (whole)": track,
        "pyramid.build": lambda: pyr.levels,
        "optical_flow.track": lambda: optical_flow.track(st.pyramid, pyr, st.features.points,
                                                         st.features.valid, s.flow),
        "ransac.estimate": est,
        "features.detect": detect,
        "mesh_motion.estimate": lambda: mesh_motion.estimate(
            st.features.points, dst, st.features.valid.to(torch.float32),
            lt.WarpField.identity(s.motion_resolution, device="cpu"), det_size, s.mesh)[0].offsets,
    }
    for name, body, state in pt.bodies(s, 1, SIZE, "cpu"):
        _, got = body(state, _zero())
        _assert_same(got, direct[name](), name)


def test_profile_tracker_batched_bodies_match_each_stream_solo():
    """S = 2: the bodies that draw nothing, batched by `streams.batched`,
    equal stream by stream to the same bodies at S = 1 (stream 0) and the
    solo call on stream 1's input (the noise scaled by 1.01)."""
    s = pt.settings_for(SIZE, mesh=True)
    two = {n: (b, st) for n, b, st in pt.bodies(s, 2, SIZE, "cpu")}
    one = {n: (b, st) for n, b, st in pt.bodies(s, 1, SIZE, "cpu")}
    for name in ("pyramid.build", "features.detect"):
        got = pytree.tree_leaves(two[name][0](two[name][1], _zero())[1])
        want = pytree.tree_leaves(one[name][0](one[name][1], _zero())[1])
        for a, b in zip(got, want):
            assert torch.equal(a[0], b), name
    det1 = resample.resize(ps.noise(SIZE) * 1.01, tuple(s.detection_size), antialias=True)
    got = two["pyramid.build"][0](two["pyramid.build"][1], _zero())[1]
    for a, b in zip(got, optical_flow.Pyramid.build(det1, s.flow.pyramid_levels).levels):
        assert torch.equal(a[1], b)


def test_profile_enhance_bodies_return_the_direct_calls():
    """Each stage against the port's own function; the fused deblock body
    against `DeblockingFilter.step` on the 16-aligned crop."""
    from livevisionkit_tpu_torch.filters import deblocking

    px = ps.noise((3, *SIZE))
    fmt = lt.PixelFormat.YUV
    small0 = resample.avg_pool(px, 4)
    up0 = resample.upsample_linear_int(px, (2, 2))
    out_size = (2 * SIZE[0], 2 * SIZE[1])
    adb = lt.DeblockingFilter(settings=lt.DeblockingFilterSettings())
    direct = {
        "deblock.avg_pool(1/4)": lambda: resample.avg_pool(px, 4),
        "deblock.median5@270p": lambda: resample.median_blur(small0, 5),
        "deblock.up_linear(4x)": lambda: resample.upsample_linear_int(small0, (4, 4)),
        "deblock.measure(luma+pools)": lambda: deblocking.block_measure(color.luma(px, fmt), 16),
        "deblock.full-fused": lambda: adb.step(None, lt.Frame.create(px, fmt=fmt))[1].pixels,
        "easu_scale 1080p->4K": lambda: easu.easu_scale(px, out_size, fmt=fmt),
        "rcas@4K": lambda: rcas.rcas(up0, 0.8),
        "easu+rcas fused": lambda: rcas.rcas(easu.easu_scale(px, out_size, fmt=fmt), 0.8),
    }
    assert SIZE[0] % 16 == 0 and SIZE[1] % 16 == 0  # the crop is the frame
    for name, body, state in pe.bodies(SIZE, "cpu"):
        _assert_same(body(state, _zero())[1], direct[name](), name)


def test_profile_serving_stages_bodies_return_the_direct_calls():
    """The ticks against `MultiStreamFilter.step`, the tracker against the
    batched track, the queue's round trip against each stream's solo push
    and pop (the buffers' storage compared too)."""
    n = 2
    pix = ps.noise((3, *SIZE))
    batch = torch.stack([pix * (1.0 + 0.01 * i) for i in range(n)])
    frames = lt.Frame(pixels=batch, timestamp=torch.zeros(n), valid=torch.ones(n, dtype=torch.bool),
                      format=lt.PixelFormat.YUV)
    base = serving_filter(SIZE)
    spec = lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV)
    rows = list(pss.bodies(n, SIZE, "cpu"))
    for (name, body, state), wf in zip(rows[:2], ("easu", "bilinear")):
        multi = MultiStreamFilter(lt.StabilizationFilter(
            settings=dataclasses.replace(base.settings, warp_filter=wf)), n)
        _assert_same(body(state, _zero()), multi.step(multi.init(spec, device="cpu"), frames), name)
    name, body, state = rows[2]
    from livevisionkit_tpu_torch.parallel.streams import batched

    tstate = pytree.tree_map(lambda x: torch.stack([x] * n),
                             frame_tracker.init(base.settings.tracker, device="cpu"))
    want = batched(lambda st, g: (lambda r: (r[0], r[1].stability))(
        frame_tracker.track(st, g, base.settings.tracker)))(tstate, batch[:, 0])
    _assert_same(body(state, _zero()), want, name)
    name, body, queue = rows[3]
    q, old = body(queue, _zero())
    cap = base.settings.smoother.predictive_samples + 1
    for i in range(n):
        template = {"pixels": torch.zeros((3, *SIZE), dtype=torch.uint8),
                    "timestamp": torch.zeros(()), "valid": torch.zeros((), dtype=torch.bool)}
        solo = StreamBuffer.create(template, cap).push(
            {"pixels": color.to_u8(batch[i]), "timestamp": torch.zeros(()),
             "valid": torch.ones((), dtype=torch.bool)})
        assert torch.equal(old[i], color.from_u8(solo.oldest()["pixels"]))
        for k in solo.data:
            assert torch.equal(q.data[k][i], solo.data[k]), k
        assert int(q.count[i]) == int(solo.count) == 1


@pytest.mark.parametrize("config", ["640x480_gray_stabilization", "1080p_deblock"])
def test_bench_matrix_bodies_return_the_direct_step(config):
    """A config's body at t = 0 against its filter's step on the same frame
    (the 4K configs' steps take seconds a call here: not run)."""
    name, filt, c, h, w, fmt = next(cfg for cfg in bmt.configs() if cfg[0] == config)
    pix = ps.noise((c, h, w), seed=3)
    body, state = bmt.body_and_state(filt, c, h, w, fmt, pix)
    want = filt.step(filt.init(lt.FrameSpec(h, w, c, fmt), device="cpu"),
                     lt.Frame.create(pix, timestamp=0.0, fmt=fmt))
    _assert_same(body(state, _zero()), want, name)


def test_bench_body_returns_the_direct_step():
    """bench_torch's body takes ring frame t % 8 at t / 60: at t = 9 the
    step of frame 1 stamped 0.15."""
    filt = serving_filter(SIZE)
    body, state = bench_torch.body_and_state(filt, SIZE, "cpu")
    ring = bench_torch.ring(SIZE, "cpu")
    t = torch.full((), 9.0)
    want = filt.step(filt.init(lt.FrameSpec(*SIZE, 3, lt.PixelFormat.YUV), device="cpu"),
                     lt.Frame.create(ring[1], timestamp=t / 60.0, fmt=lt.PixelFormat.YUV))
    _assert_same(body(state, t), want, "bench")
    assert ring.shape == (8, 3, *SIZE) and torch.equal(ring[:, 0], ring[:, 2])


# ------------------------------------------------------------- --json-out

@pytest.mark.parametrize("tool", [bmt, ps, pt, pe, pss], ids=lambda m: m.__name__)
def test_json_out_refuses_bench_records(tool, tmp_path):
    """Before any measurement: no row is printed, the file is not made."""
    path = tmp_path / "BENCH_MATRIX.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(ValueError, match="BENCH_"):
        tool.main(["--device", "cpu", "--json-out", str(path)])
    assert out.getvalue() == "" and not path.exists()


def test_json_out_appends_rows(tmp_path):
    path = tmp_path / "rows.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = pe.main(["--device", "cpu", "--size", "32x32", "--n", "1", "--reps", "1",
                        "--json-out", str(path)])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["row"] for ln in lines] == [name for name, _ in rows]
    assert all(ln["device"] == "cpu" and ln["ms"] > 0 for ln in lines)
    printed = out.getvalue().splitlines()
    assert printed[0].startswith("deblock.avg_pool(1/4)") and printed[0].endswith(" ms")
