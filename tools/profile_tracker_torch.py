"""Sub-stage latency profile of the PyTorch port's `frame_tracker.track`
(the counterpart of tools/profile_tracker.py).

Usage:
    python tools/profile_tracker_torch.py [S] [--device cuda|cpu] [--size 1080x1920]
        [--mesh] [--n 60] [--reps 3] [--json-out FILE]

Rows, under the JAX tool's names, over S streams of 1080p gray noise
(stream i scaled by 1 + 0.01 i) with the flagship's tracker (below 540
rows the dry run's tiny one, for CPU runs): track (whole), the pyramid
build, LK (optical_flow.track, K3), RANSAC (ransac.estimate), FAST
detection, and, when the tracker's motion field is not 2x2 (--mesh: the
`stabilization_preset(model="field")` tracker, a 16x16 mesh), the mesh
solve.  Every stage reads a tracker state seeded by two tracks outside
the timing, as the JAX tool's do.  At S = 1 each stage is the solo call;
at S > 1 it is batched over the streams by `parallel/streams.batched`
(`torch.func.vmap` with no per-stream fallback, so an op without a
batching rule raises, as in `MultiStreamFilter`).  A stage that draws
(track, RANSAC) keeps its tracker state, and so the RANSAC generator, in
the compiled step's state, where the capture registers it; such a body
returns that state unchanged, so every replay tracks from the same
seeded state.  Timing: tools/profile_stages_torch.graph_time.
`tracker` is the function chip_smoke.py calls in-process.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_stages_torch import noise, show, time_rows  # noqa: E402
from serving_torch import (  # noqa: E402
    append,
    card_line,
    check_json_out,
    log,
    parse_size,
    serving_filter,
)


def settings_for(size: tuple[int, int], mesh: bool = False):
    """The tracker profiled: the served filter's at `size`, or with `mesh`
    the mesh preset's."""
    from livevisionkit_tpu_torch import presets

    if mesh:
        return presets.stabilization_preset(model="field").tracker
    return serving_filter(size).settings.tracker


def header(s, n_streams: int) -> str:
    """The JAX tool's first line."""
    return (f"S={n_streams} motion_resolution={s.motion_resolution}, "
            f"grid={s.detector.grid_shape}, max_features={s.detector.max_features}, "
            f"hypotheses={s.motion.hypotheses}, levels={s.flow.pyramid_levels}")


def bodies(s, n_streams: int = 1, size: tuple[int, int] = (1080, 1920), device="cuda"):
    """(name, body, state) of each row for the tracker settings `s` over
    `n_streams` streams of `size` (the module docstring)."""
    import torch
    import torch.utils._pytree as pytree

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.ops import resample
    from livevisionkit_tpu_torch.parallel.streams import batched
    from livevisionkit_tpu_torch.vision import features, frame_tracker, mesh_motion, optical_flow, ransac
    from livevisionkit_tpu_torch.vision.optical_flow import Pyramid

    dev = torch.device(device)
    solo = n_streams == 1
    over = (lambda fn: fn) if solo else batched
    det_size, levels = tuple(s.detection_size), s.flow.pyramid_levels

    def stacked(x):
        return x if solo else pytree.tree_map(lambda t: torch.stack([t] * n_streams), x)

    gray1 = noise(size)
    gray = torch.stack([gray1 * (1.0 + 0.01 * i) for i in range(n_streams)]).to(dev)
    gray = gray[0] if solo else gray
    det = over(lambda g: resample.resize(g, det_size, antialias=True))(gray)

    def track(st, g):
        st, res = frame_tracker.track(st, g, s)
        return st, (res.motion.offsets, res.stability)

    track_v = over(track)
    st = stacked(frame_tracker.init(s, device=dev))
    st, _ = track_v(st, gray)
    st, _ = track_v(st, gray)
    pyr = over(lambda d: Pyramid.build(d, levels))(det)

    def t_track(st_, t):
        return st_, track_v(st_, gray + 1e-6 * t)[1]

    yield "track (whole)", t_track, st

    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def t_pyr(c, t):
        return c, over(lambda d: Pyramid.build(d, levels).levels)(det + 1e-6 * t)

    yield "pyramid.build", t_pyr, zero

    def t_flow(c, t):
        return c, over(lambda sp, pp, fp, fv: optical_flow.track(sp, pp, fp, fv, s.flow))(
            st.pyramid, pyr, st.features.points + 1e-6 * t, st.features.valid)

    yield "optical_flow.track", t_flow, zero

    dst = st.features.points + 0.5
    use_h = torch.ones((), dtype=torch.bool, device=dev)

    def t_ransac(st_, t):
        def est(fp, d, fv):
            e = ransac.estimate(fp, d, fv, st_.generator, s.motion, use_homography=use_h,
                                min_samples=s.min_motion_samples)
            return e.homography.m, e.stability

        return st_, over(est)(st_.features.points, dst + 1e-6 * t, st_.features.valid)

    yield "ransac.estimate", t_ransac, st

    def t_detect(c, t):
        def det_fn(d, th):
            fs, thr = features.detect(d, th, s.detector)
            return fs.points, fs.valid, thr

        return c, over(det_fn)(det + 1e-6 * t, st.thresholds)

    yield "features.detect", t_detect, zero

    if tuple(s.motion_resolution) != (2, 2):
        warm = stacked(lt.WarpField.identity(s.motion_resolution, device=dev))

        def t_mesh(c, t):
            def solve(fp, d, fv, w):
                return mesh_motion.estimate(fp, d, fv, w, det_size, s.mesh)[0].offsets

            return c, over(solve)(st.features.points, dst + 1e-6 * t,
                                  st.features.valid.to(torch.float32), warm)

        yield "mesh_motion.estimate", t_mesh, zero


def tracker(n_streams: int = 1, size: tuple[int, int] = (1080, 1920), device="cuda",
            mesh: bool = False, n: int = 60, reps: int = 3) -> list[tuple[str, float]]:
    """The rows, (name, ms) in the JAX tool's order."""
    return time_rows(bodies(settings_for(size, mesh), n_streams, size, device), n, reps)


def main(argv=None) -> list[tuple[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("streams", nargs="?", type=int, default=1, help="S, the streams")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--mesh", action="store_true", help="the mesh preset's tracker (16x16)")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the least is kept")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    size = parse_size(args.size)
    card = card_line(args.device)
    log(f"profile_tracker on {card}, {size[0]}x{size[1]}")
    print(header(settings_for(size, args.mesh), args.streams), flush=True)
    rows = tracker(args.streams, size, args.device, args.mesh, args.n, args.reps)
    for name, ms in rows:
        show(name, ms)
        append({"tool": "profile_tracker", "row": name, "ms": ms, "streams": args.streams,
                "mesh": args.mesh, "device": card, "size": f"{size[0]}x{size[1]}"}, args.json_out)
    return rows


if __name__ == "__main__":
    main()
