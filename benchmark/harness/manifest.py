"""The manifest (`BENCHMARK.json` at the checkout's root) and the files it
names, found by name:

  configs/<config>.json   a configuration: frame size, format, the filter
                          chain with every setting, its source and cuts;
  traffic/<traffic>.json  a traffic mix: its driver and its parameters;
  limits/<cell>.json      the limits of the numbers `correct` compares;
  metrics/<name>.py       a per-layer metric's reader, `read(run)` (a
                          name `<quantity>.<suffix>` without a file of
                          its own takes metrics/<quantity>.py).

A later change adds a configuration, a mix, a cell or a metric by adding a
file and an entry, never by editing one."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest with what it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell}.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a manifest metric is reported in `cell` (no `workloads`
    key: in every cell)."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest if manifest is not None else load_manifest()
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in the manifest")
    w = entries[0]
    return Cell(
        name=name,
        config=config(w["config"]),
        traffic=traffic(w["traffic"]),
        limits=limits(name),
        chips=int(w["chips"]),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)],
    )


def metric_reader(name: str) -> ModuleType:
    """metrics/<name>.py, loaded from its path (a name may hold dots); where
    there is none, the reader of the name without its last `.<suffix>`
    (`step_busy_ms.live60` falls back to metrics/step_busy_ms.py): a
    quantity split by cell shares one reader, which takes what differs from
    the cell (such as `run.cell.traffic["rate_metric"]`)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    base = name
    while not path.exists() and "." in base:
        base = base.rsplit(".", 1)[0]
        path = BENCH_DIR / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None or not path.exists():
        raise FileNotFoundError(BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
