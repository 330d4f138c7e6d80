"""The port's serving tools on the CPU at small sizes
(tools/bench_multistream_torch.py, tools/bench_scaling_torch.py,
tools/bench_latency_torch.py): the loopback's gates, the soak's session
limit, the end-to-end rows, the scaling rows and the latency rows, over
the dry run's tiny flagship at 96x128.  The soaks, a minimal one of 3
sessions (~12 s) and one of 60 s, are `slow`, as the JAX tool's is
(tests/test_multistream.py)."""

import json
import math
import os
import subprocess
import sys
import threading

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench_latency_torch as bl  # noqa: E402
import bench_multistream_torch as bm  # noqa: E402
import bench_scaling_torch as bs  # noqa: E402
import serving_torch  # noqa: E402
from livevisionkit_tpu_torch.parallel import dryrun  # noqa: E402

SIZE = (96, 128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loopback_four_streams():
    """4 streams x 24 frames: the slow stream bubbled, the early-EOF stream
    ended at half, the fast streams complete, every fed frame out."""
    row = bm.loopback(dryrun.tiny_flagship(), 4, SIZE, 24, "cpu")
    assert row["stalls"] > 0
    assert row["per_stream_out"] == [24, 12, 24, 24]
    assert row["frames_in"] == row["frames_out"] == 84
    assert row["graphs"] == 0 and row["aggregate_fps"] > 0
    json.dumps(row)


@pytest.mark.slow
def test_soak_three_sessions():
    """A minimal soak: 3 sessions of 4 streams x 15 frames, the slow and
    early-EOF streams rotating, every gate of the tool held (~12 s here)."""
    row = bm.soak(dryrun.tiny_flagship(), 4, SIZE, 15, 0.0, "cpu")
    assert row["sessions"] == 3
    assert row["frames_total"] == 3 * (15 * 3 + 7)
    assert row["stalls_total"] >= 3
    assert [s["graphs"] for s in row["per_session"]] == [0, 0, 0]


def test_soak_session_limit_raises_on_a_hang():
    """A session that does not end within its wall-clock limit (a reader
    that never yields: the driver waits for every stream's first frame)
    raises instead of hanging the soak."""
    release = threading.Event()

    def stuck():
        release.wait()
        return
        yield

    try:
        with pytest.raises(TimeoutError):
            bm._timed_session(dryrun.tiny_flagship(), [stuck(), stuck()], None, "cpu", 0.5)
    finally:
        release.set()


@pytest.mark.slow
def test_soak_sixty_seconds():
    """The soak tool for 60 s (as tests/test_multistream.py's JAX soak)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "bench_multistream_torch.py"), "--device", "cpu",
         "--soak", "60", "--streams", "4", "--size", "96x128", "--frames", "15"],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "soak OK" in proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["sessions"] >= 3


def test_end_to_end_rows():
    """Two rendered shaky clips through `stream_multi`: every frame out,
    the steady and whole-run rates and the transfer floor reported."""
    clips = bm.shaky_clips(2, 12, SIZE, "cpu")
    assert len(clips) == 2 and clips[0][0][0].shape == (*SIZE, 3)
    assert clips[0][0][0].dtype.name == "uint8" and clips[0][1][1] == 1 / 30.0
    row = bm.end_to_end(dryrun.tiny_flagship(), clips, "cpu")
    assert row["frames_in"] == row["frames_out"] == 24
    assert row["target_fps"] == 480.0 and row["met"] == (row["steady_state_fps"] >= 480.0)
    assert row["transfer_floor_ms"] > 0 and row["steady_state_fps"] > 0


def test_scaling_rows():
    """S = 1, 2: well-formed rows, efficiency t(1) * S / t(S)."""
    rows = list(bs.scaling(dryrun.tiny_flagship(), [1, 2], SIZE, "cpu", ticks=2))
    assert [r["streams"] for r in rows] == [1, 2]
    assert rows[0]["scaling_efficiency"] == 1.0
    t1, t2 = rows[0]["ms_per_step"], rows[1]["ms_per_step"]
    assert math.isclose(rows[1]["scaling_efficiency"], t1 * 2 / t2)
    for r in rows:
        assert r["mode"] == "vmap_1card" and r["target"] == 0.8
        assert math.isclose(r["frames_per_s"], 1e3 * r["streams"] / r["ms_per_step"])
        assert r["met"] == (r["scaling_efficiency"] >= 0.8)
        json.dumps(r)


def test_scaling_control_and_mesh_rows():
    control = list(bs.scaling(None, [1, 2], SIZE, "cpu", ticks=2, control=True))
    assert [r["mode"] for r in control] == ["vmap_1card_control"] * 2
    mesh = list(bs.scaling(dryrun.tiny_flagship(), [2], SIZE, "cpu", ticks=1, mesh=True, base_ms=1.0))
    assert mesh[0]["mode"] == "mesh" and math.isclose(mesh[0]["scaling_efficiency"],
                                                      1.0 / mesh[0]["ms_per_step"])


def test_latency_rows_unpaced():
    """The unpaced latency tool over 12 frames: the identity row, the
    stabilizer's row and their difference."""
    rows = bl.latency(dryrun.tiny_flagship(), SIZE, frames=12, fps=0.0, warmup=4, device="cpu")
    assert [r["config"] for r in rows] == ["identity_pipeline_floor", "vs_96p_latency",
                                            "vs_minus_identity"]
    for r in rows[:2]:
        assert r["frames"] == 12 and 0 < r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
        assert math.isclose(r["limit_ms"], 4 * 1000 / 60) and r["met"] == (r["p99_ms"] <= r["limit_ms"])
    delta = rows[2]
    assert math.isclose(delta["p50_ms"], rows[1]["p50_ms"] - rows[0]["p50_ms"])
    assert delta["graph_step_ms"] > 0 and delta["delay_queue_frames"] == 2
    assert delta["reference_budget_ms"] == 6.0


def test_rows_append_but_not_to_the_jax_records(tmp_path):
    out = tmp_path / "rows.jsonl"
    serving_torch.emit({"a": 1}, str(out))
    serving_torch.emit({"a": 2}, str(out))
    assert [json.loads(x)["a"] for x in out.read_text().splitlines()] == [1, 2]
    with pytest.raises(ValueError):
        serving_torch.emit({"a": 3}, str(tmp_path / "BENCH_SCALING.jsonl"))
