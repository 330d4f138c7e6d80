"""Port parity of the `lvk-torch` CLI (runtime/cli.py) against the JAX
package's `lvk`: the filter specs build field-equal filters, `-p` profiles
expand the same way, the parser carries every option of `lvk` with the
same destination and default, and a run on a small clip writes the same
number of frames and the same CSV layout; `-C` lists the same encoders."""

import csv
import dataclasses
import enum
import json

import numpy as np
import pytest

import fixtures
from livevisionkit_tpu.runtime import cli as jcli
from livevisionkit_tpu_torch.runtime import cli as tcli

SPECS = [
    "vs.smoothing=15.crop_out=1.crop_prop=0.08.qa=strict",
    "stab.mesh=8.debug=1",
    "vs.model=field",
    "adb.levels=4",
    "deblocker",
    "fsr.size=640x360.sharpness=0.5",
    "scale",
    "cas.sharpness=0.3",
    "sharpen",
    "rcas.sharpness=0.6",
    "lc.profile={profile}.alpha=0.5",
    "conv.format=rgb.extract=1",
    "convert",
]


def _tree(obj):
    """A filter as plain data: class names, field names and values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: _tree(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    return obj


@pytest.fixture
def profile(tmp_path, monkeypatch):
    """A camera profile by a relative name without dots: the spec grammar
    splits options on '.'."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "camera").write_text(json.dumps({
        "fx": 420.0, "fy": 410.0, "cx": 160.0, "cy": 120.0, "k1": -0.25, "k2": 0.07,
        "p1": 0.001, "p2": -0.001, "k3": 0.0}))
    return "camera"


@pytest.mark.parametrize("spec", SPECS)
def test_build_filter_matches_jax(spec, profile):
    spec = spec.format(profile=profile)
    name, opts = tcli._parse_filter_spec(spec)
    assert (name, opts) == jcli._parse_filter_spec(spec)
    assert _tree(tcli._build_filter(name, opts)) == _tree(jcli._build_filter(name, opts))


def test_build_filter_errors():
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            cli._build_filter("nope", {})
        with pytest.raises(SystemExit):
            cli._build_filter("lc", {})


def test_expand_profile_matches_jax(tmp_path):
    prof = tmp_path / "args.txt"
    prof.write_text("-f vs.smoothing=5\n-n 12   -v\n--compile-cache /tmp/x\n")
    argv = ["in.mp4", "-p", str(prof), "out.mp4", "--profile", str(prof), "-c", "MJPG"]
    got = tcli.expand_profile(argv)
    assert got == jcli.expand_profile(argv)
    assert got[:8] == ["in.mp4", "-f", "vs.smoothing=5", "-n", "12", "-v", "--compile-cache", "/tmp/x"]
    args = tcli.make_parser().parse_args(got)
    assert args.frames == 12 and args.compile_cache == "/tmp/x" and args.device == "cuda"


def test_parser_carries_every_lvk_option():
    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, type(a).__name__)
                for a in parser._actions}

    want, got = actions(jcli.make_parser()), actions(tcli.make_parser())
    assert set(got) - set(want) == {"device"}
    for dest, value in want.items():
        assert got[dest] == value, dest
    assert got["device"][:2] == (("--device",), "cuda")


def _write_clip(path, n=10, size=(48, 64)):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    base = fixtures.make_texture(200, 200, rng)
    poses, _ = fixtures.shaky_path(n, rng, margin=50.0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (size[1], size[0]))
    assert w.isOpened()
    for p in poses:
        g = np.asarray(fixtures.render_frame(base, p, size))
        w.write(np.clip(np.stack([g, 0.8 * g, np.roll(g, 2, 1)], -1) * 255, 0, 255).astype(np.uint8))
    w.release()


def _count_frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    n = 0
    while cap.read()[0]:
        n += 1
    return n


def test_main_end_to_end_matches_lvk(tmp_path):
    """`lvk-torch --device cpu -f adb -f cas -n 8 -L csv in out` against
    `lvk` with the same arguments: 8 frames written by each, and CSVs with
    the same rows (metric, name, count), times aside."""
    src = str(tmp_path / "in.avi")
    _write_clip(src)
    rows = {}
    for name, cli, extra in (("lvk", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out, log = str(tmp_path / f"{name}.avi"), str(tmp_path / f"{name}.csv")
        assert cli.main(extra + ["-f", "adb", "-f", "cas", "-n", "8", "-L", log, "-c", "MJPG",
                                 "-v", src, out]) == 0
        assert _count_frames(out) == 8
        with open(log) as fh:
            rows[name] = list(csv.reader(fh))
    assert rows["torch"][0] == ["metric", "name", "avg_ms", "dev_ms", "count"]
    assert [(r[0], r[1], r[4]) for r in rows["torch"]] == [(r[0], r[1], r[4]) for r in rows["lvk"]]
    stats = {r[0]: r for r in rows["torch"][1:]}
    assert stats["frames_in"][4] == stats["frames_out"][4] == "8"
    assert float(stats["frame_time"][2]) > 0


def test_main_profile_filters_rows(tmp_path):
    """--profile-filters adds one filter_time row per chain element, named
    as the JAX CLI names them."""
    src = str(tmp_path / "in.avi")
    _write_clip(src, n=4)
    log = str(tmp_path / "t.csv")
    assert tcli.main(["--device", "cpu", "-f", "cas", "-f", "conv.format=rgb", "--profile-filters",
                      "-L", log, src]) == 0
    with open(log) as fh:
        per_filter = [r for r in csv.reader(fh) if r[0] == "filter_time"]
    assert [r[1] for r in per_filter] == ["0:CASFilter", "1:ConversionFilter"]
    assert all(int(r[4]) == 4 for r in per_filter)


def test_list_encoders_matches_lvk(capsys):
    pytest.importorskip("cv2")
    assert jcli.main(["-C"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["-C"]) == 0
    got = capsys.readouterr().out
    assert got == want and "available" in got
