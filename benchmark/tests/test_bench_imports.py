"""Nothing the benchmark loads has `jax`, `jaxlib`, `flax` or the JAX
package (`livevisionkit_tpu`) as its top-level name, compared whole (the
port's name begins with the JAX package's), and the reference's own modules
import nothing of the port."""

import ast
import json
import subprocess
import sys

from tiny import BENCH

import run as bench_run

PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from harness import manifest, build, judge, render, roofline, stage, trace
import control, faults, drivers.clip, drivers.live, drivers.multi
for m in manifest.load_manifest()["per_layer"]:
    manifest.metric_reader(m["name"])
{extra}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(extra: str = "") -> list[str]:
    code = PROBE.format(bench=str(BENCH), root=str(BENCH.parent), extra=extra)
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_port_load_no_jax():
    extra = ("import livevisionkit_tpu_torch\n"
             "import livevisionkit_tpu_torch.runtime.offline, livevisionkit_tpu_torch.runtime.stream\n"
             "import livevisionkit_tpu_torch.runtime.multistream, livevisionkit_tpu_torch.utils.compiled")
    loaded = _loaded(extra)
    assert "livevisionkit_tpu_torch" in loaded
    bad = [m for m in loaded if m.split(".")[0] in bench_run.FORBIDDEN]
    assert not bad, bad


def test_forbidden_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["livevisionkit_tpu_torch_probe"] = sys
        assert not [m for m in bench_run.forbidden_modules() if m.startswith("livevisionkit_tpu_torch")]
        sys.modules["jax.numpy"] = sys
        assert "jax.numpy" in bench_run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("__future__", "dataclasses", "importlib", "typing", "numpy", "torch",
                                              "reference"), f"{path.name} imports {name}"
    loaded = _loaded("import reference.stabilizer, reference.compare, reference.filters.deblocking\n"
                     "import reference.filters.cas, reference.warps.easu")
    # The harness above does not load the port either: only the drivers do, inside run().
    assert not [m for m in loaded if m.split(".")[0] == "livevisionkit_tpu_torch"]
