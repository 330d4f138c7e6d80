"""The manifest and the files it names: every configuration, traffic mix,
limit file and per-layer reader is found by name and parses; names and
units keep to their characters; each per-layer metric moves an end-to-end
metric that every cell it lists reports."""

import json
import re

import pytest

from tiny import BENCH  # (also puts the benchmark on sys.path)

from harness import manifest

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse(name):
    cell = manifest.cell(name, M)
    assert cell.config["name"] == next(w["config"] for w in M["workloads"] if w["name"] == name)
    assert cell.traffic["driver"] in ("clip", "live", "multi")
    for key in ("interior_margin_px", "min_compared", "misalign_px", "residual_u8"):
        assert key in cell.limits
    # Each filter after the stabilizer is judged by its gap, with a limit.
    for f in cell.config["filters"][1:]:
        assert f"{f['type']}_gap" in cell.limits
    assert cell.chips == 1


@pytest.mark.parametrize("entry", M["configs"], ids=[c["name"] for c in M["configs"]])
def test_config_builds_by_name(entry):
    # Each filter's class and settings come from the file by name, and its
    # reference from reference/filters/<type>.py.
    from harness.build import build_filter

    cfg = manifest.config(entry["name"])
    filt = build_filter(cfg)
    chain = getattr(filt, "filters", (filt,))
    assert [type(f).__name__ for f in chain] == [f["class"] for f in cfg["filters"]]
    for f in cfg["filters"][1:]:
        assert (BENCH / "reference" / "filters" / f"{f['type']}.py").exists()


def test_metric_reader_falls_back_to_the_quantity():
    assert manifest.metric_reader("step_busy_ms.any_cell").__file__.endswith("metrics/step_busy_ms.py")
    with pytest.raises(FileNotFoundError):
        manifest.metric_reader("no_such_metric.multi")


@pytest.mark.parametrize("entry", M["configs"], ids=[c["name"] for c in M["configs"]])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = manifest.config(entry["name"])
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in M["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_names_and_units(metric):
    assert manifest.NAME.match(metric["name"])
    assert manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_workload_names():
    for w in M["workloads"]:
        for key in ("name", "config", "traffic"):
            assert manifest.NAME.match(w[key]), w[key]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("metric", M["end_to_end"], ids=[m["name"] for m in M["end_to_end"]])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", M["per_layer"], ids=[m["name"] for m in M["per_layer"]])
def test_per_layer_reader_and_moves(metric):
    reader = manifest.metric_reader(metric["name"])
    assert callable(reader.read)
    moved = next(m for m in M["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert manifest.reports(moved, cell), f"{cell} does not report {moved['name']}"
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert re.match(r"^[a-z0-9_]+_roofline(\.[a-z0-9_]+)?$", metric["name"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_enough(name):
    cell = manifest.cell(name, M)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_layers_spelled_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    assert layers == {"device", "compiled step", "kernels", "tracker", "filters", "driver"}
