"""tools/profile_warp_torch.py on the CPU at a small size: its rows carry
the JAX warp profilers' names where those have the row (read from their
sources as text, never imported), every time is finite and positive, each
body gives what the port call it times gives, and on the CPU every EASU
and bilinear row runs the warp's plain versions (ops/remap.remap_plain
solo, remap_batched_plain over streams), as many as the kernels'
launches that chip_smoke.py holds the tool to on the card.  A few seconds
here; none is `slow`."""

import contextlib
import io
import json
import math
import os
import re
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import profile_warp_torch as pw  # noqa: E402

import livevisionkit_tpu_torch as lt  # noqa: E402
from livevisionkit_tpu_torch.ops import remap as remap_ops  # noqa: E402

SIZE = (24, 40)
STREAMS = (1, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as fh:
        return fh.read()


def _zero():
    return torch.zeros((), dtype=torch.float32)


def test_rows_carry_the_jax_tools_names():
    """warp.apply is tools/profile_stages.py's row, warpfield.apply
    tools/profile_warp.py's, and each S's batched and per-stream rows
    tools/profile_easu_serving.py's, whose f-string fields are S and the
    filter's name."""
    stages = re.findall(r'print\(f"(.+?):\s*\{scan_time\b', _source("tools/profile_stages.py"))
    warp = re.findall(r'print\(f"(.+?):\s*\{scan_time\b', _source("tools/profile_warp.py"))
    serving = sorted(set(re.findall(r'print\(\s*f"(S=\{S\} (?:easu|bilinear) (?:batched|lax\.map))\s*:',
                                    _source("tools/profile_easu_serving.py"))))
    assert "warp.apply 1080p" in stages and "warpfield.apply 1080p" in warp
    assert serving == ["S={S} bilinear batched", "S={S} bilinear lax.map", "S={S} easu batched",
                       "S={S} easu lax.map"]
    names = [(name, filt) for name, filt, _, _, _ in pw.bodies(SIZE, "cpu", STREAMS)]
    assert names[:2] == [("homography.sample_map 1080p", "-"), ("warpfield.sample_map 1080p", "-")]
    for filt in pw.FILTERS:
        rows = [n for n, f in names if f == filt]
        want = ["warp.apply 1080p", "warpfield.apply 1080p", "homography.warp 1080p",
                "warp kernel 1080p"] + [f"S={s} {filt} {kind}" for s in STREAMS
                                        for kind in ("batched", "lax.map")]
        assert rows == want * len(pw.DTYPES)
        assert {r for r in rows if r.startswith("S=")} == {
            t.format(S=s) for t in serving if f" {filt} " in t for s in STREAMS}


def test_profile_times_are_finite_and_positive():
    rows = pw.profile(SIZE, "cpu", n=1, reps=1, streams=(1,))
    assert len(rows) == 2 + 2 * 2 * (4 + 2)
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    assert {(r["filter"], r["dtype"]) for r in rows[2:]} == {
        (f, d) for f in pw.FILTERS for d in pw.DTYPES}
    parts = pw.split(rows)
    for p in parts.values():
        assert math.isclose(p["map"] + p["kernel"] + p["rest"], p["warp.apply"], rel_tol=1e-9)


@pytest.fixture
def plain_calls(monkeypatch):
    """The (kernel, filter mode) of each plain warp called: "warp" for the
    solo plain version (K1 on the card), "warp_batched" for the batched
    one (K2), whose own per-stream solo calls are not counted."""
    calls, nested = [], []
    solo, batched = remap_ops.remap_plain, remap_ops.remap_batched_plain

    def counted_solo(*a, **k):
        if not nested:
            calls.append(("warp", k["filter_mode"]))
        return solo(*a, **k)

    def counted_batched(*a, **k):
        calls.append(("warp_batched", k["filter_mode"]))
        nested.append(1)
        try:
            return batched(*a, **k)
        finally:
            nested.pop()

    monkeypatch.setattr(remap_ops, "remap_plain", counted_solo)
    monkeypatch.setattr(remap_ops, "remap_batched_plain", counted_batched)
    return calls


def test_bodies_run_the_plain_warps_on_the_cpu(plain_calls):
    """Each row's body calls the plain solo warp as many times as the card
    launches K1 for it and the plain batched warp as many as K2, in its
    own filter mode, and no kernel wrapper (they raise on CPU tensors)."""
    for name, filt, dtype, body, state in pw.bodies(SIZE, "cpu", STREAMS):
        plain_calls.clear()
        _, out = body(state, _zero())
        s = int(name.split()[0][2:]) if name.startswith("S=") else 1
        if filt == "-":
            want = []
        elif name.endswith("batched"):
            want = [("warp_batched", filt)]
        elif name.endswith("lax.map"):
            want = [("warp", filt)] * s
        else:
            want = [("warp", filt)]
        assert plain_calls == want, name
        for t in out if isinstance(out, list) else [out]:
            assert t.dtype == (torch.float32 if dtype == "f32" else torch.uint8)


def test_chip_smoke_holds_the_tool_to_its_rows_and_launches(plain_calls):
    """chip_smoke.py's row names and launch counts for the tool (a step of
    each row's body: its graph's capture) are the tool's own at its default
    streams."""
    import chip_smoke

    rows = list(pw.bodies(SIZE, "cpu"))
    assert tuple(name for name, *_ in rows) == chip_smoke.TOOL_ROWS["profile_warp"]
    for _, _, _, body, state in rows:
        body(state, _zero())
    got = {"warp": sum(k == "warp" for k, _ in plain_calls),
           "warp_batched": sum(k == "warp_batched" for k, _ in plain_calls),
           "warp_batched_bilinear": plain_calls.count(("warp_batched", "bilinear"))}
    assert got == chip_smoke.TOOL_LAUNCHES["profile_warp"]


def test_bodies_return_the_port_calls():
    """Each body at t = 0 against the port call it times, on the same
    inputs: the whole warps, the kernel alone, and K2's stack against the
    S solo warps (bit-equal on the CPU, where both are the plain ops)."""
    dev = "cpu"
    coarse = lt.WarpField.identity((2, 2), device=dev).offsets + 0.01
    dense = lt.WarpField.identity(pw.FIELD, device=dev).offsets + 0.01
    h = lt.WarpField(offsets=coarse).to_homography(SIZE)
    out = {}
    for name, filt, dtype, body, state in pw.bodies(SIZE, dev, STREAMS):
        out[(name, filt, dtype)] = body(state, _zero())[1]
    assert torch.equal(out[("homography.sample_map 1080p", "-", "f32")], h.sample_map(SIZE))
    assert torch.equal(out[("warpfield.sample_map 1080p", "-", "f32")],
                       lt.WarpField(offsets=dense).sample_map(SIZE))
    for filt in pw.FILTERS:
        for dtype in pw.DTYPES:
            kw = dict(fill=0.0, filter_mode=filt, fmt=lt.PixelFormat.YUV)
            stack = pw.frames(max(STREAMS), SIZE, dtype, dev)
            pix = stack[0]
            key = lambda n: out[(n, filt, dtype)]  # noqa: E731
            assert torch.equal(key("warp.apply 1080p"), lt.WarpField(offsets=coarse).apply(pix, **kw))
            assert torch.equal(key("warpfield.apply 1080p"),
                               lt.WarpField(offsets=dense).apply(pix, **kw))
            assert torch.equal(key("homography.warp 1080p"), h.warp(pix, **kw))
            assert torch.equal(key("warp kernel 1080p"), key("homography.warp 1080p"))
            for s in STREAMS:
                assert torch.equal(key(f"S={s} {filt} batched"),
                                   torch.stack(key(f"S={s} {filt} lax.map")))


def test_main_prints_rows_and_refuses_bench_records(tmp_path):
    path = tmp_path / "rows.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = pw.main(["--device", "cpu", "--size", "16x24", "--streams", "1", "--n", "1",
                        "--reps", "1", "--json-out", str(path)])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["row"] for ln in lines] == [r["row"] for r in rows]
    assert all(ln["device"] == "cpu" and ln["tool"] == "profile_warp" for ln in lines)
    printed = out.getvalue().splitlines()
    assert printed[0].startswith("homography.sample_map 1080p:") and printed[0].endswith("(-, f32)")
    assert sum(ln.startswith("warp.apply split (") for ln in printed) == 4
    with pytest.raises(ValueError, match="BENCH_"):
        pw.main(["--device", "cpu", "--json-out", str(tmp_path / "BENCH_WARP.jsonl")])


def test_tool_imports_no_jax():
    """The tool imports, and runs a tiny CPU pass, with jax, flax, the JAX
    package and OpenCV unimportable."""
    import subprocess

    code = (
        "import sys\n"
        "for k in ('jax', 'jaxlib', 'flax', 'livevisionkit_tpu', 'cv2'):\n"
        "    sys.modules[k] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "sys.path.insert(0, 'tools')\n"
        "import profile_warp_torch as pw\n"
        "rows = pw.profile((16, 24), 'cpu', n=1, reps=1, streams=(1,))\n"
        "print(len(rows))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == str(2 + 2 * 2 * (4 + 2))
