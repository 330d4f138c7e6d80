"""`lvk-calibrate`: camera calibration from a chessboard video (counterpart
of livevisionkit_tpu/runtime/calibrate_cli.py).

Reference parity: the OBS CCTool capture workflow (reference Modules/
OBS-Plugin/Sources/Tools/CCTool.cpp): a 9x6 chessboard, 25 required
captures (:30-35), calibrate, persist the profile (fx,fy,cx,cy,k1,k2,p1,
p2,k3; :120-177).  Here the capture loop reads a video file / camera,
auto-selects sharp well-spread board views, and writes the JSON profile the
`lvk-torch -f lc.profile=...` filter consumes.  The corner response runs
on `--device` (default cuda); the rest is host numpy.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lvk-calibrate",
        description="Calibrate a camera from chessboard footage",
    )
    p.add_argument("input", help="video of a moving chessboard (or device idx)")
    p.add_argument("output", help="profile JSON to write")
    p.add_argument("--pattern", default="9x6", help="inner corners COLSxROWS")
    p.add_argument("--captures", type=int, default=25,
                   help="board views to collect (reference default 25)")
    p.add_argument("--square-size", type=float, default=1.0,
                   help="square edge length (unit of the extrinsics)")
    p.add_argument("--every", type=int, default=5, help="test every Nth frame")
    p.add_argument("--device", default="cuda",
                   help="torch device of the corner response (default: cuda)")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    import torch

    from livevisionkit_tpu_torch.runtime import video_io
    from livevisionkit_tpu_torch.vision import calibration, chessboard

    cols, rows = (int(v) for v in args.pattern.lower().split("x"))
    obj = (
        np.stack(
            np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows)), -1
        ).reshape(-1, 2)
        * args.square_size
    )

    src = int(args.input) if args.input.isdigit() else args.input
    reader = video_io.VideoReader(src)
    size = (reader.meta.height, reader.meta.width)

    views, centroids = [], []
    for i, (bgr, _ts) in enumerate(reader):
        if i % args.every:
            continue
        gray = bgr.mean(axis=2).astype(np.float32) / 255.0
        corners = chessboard.find_chessboard(torch.from_numpy(gray).to(args.device),
                                             pattern=(cols, rows))
        if corners is None:
            continue
        c = corners.mean(axis=0)
        # Require spatial diversity between captures (the reference's HUD
        # guides the user to move the board; we enforce it automatically).
        if centroids and min(np.linalg.norm(c - o) for o in centroids) < 25:
            continue
        views.append(corners)
        centroids.append(c)
        print(f"\rcaptured {len(views)}/{args.captures}", end="", file=sys.stderr)
        if len(views) >= args.captures:
            break
    reader.close()
    print(file=sys.stderr)

    if len(views) < max(4, args.captures // 3):
        print(f"only {len(views)} usable views found; need more", file=sys.stderr)
        return 1

    params, rms = calibration.calibrate([obj] * len(views), views, size)
    with open(args.output, "w") as f:
        json.dump(params.to_dict(), f, indent=2)
    print(
        f"calibrated from {len(views)} views, RMS {rms:.3f} px -> {args.output}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
