"""Stage-level profile of the PyTorch port's S-stream 1080p serving tick
(the counterpart of tools/profile_serving_stages.py).

Usage:
    python tools/profile_serving_stages_torch.py [S] [--device cuda|cpu]
        [--size 1080x1920] [--n 60] [--reps 3] [--json-out FILE]

Rows, under the JAX tool's names, over S (default 8) streams of 1080p
YUV noise (stream i scaled by 1 + 0.01 i) with the flagship filter (below
540 rows the dry run's tiny one, for CPU runs): the whole tick of
`MultiStreamFilter(filt, S)` (the graph `MultiStreamFilter.jit_step()`
replays) with the EASU warp and with the bilinear one, the batched
`frame_tracker.track`, and the u8 delay queue's round trip (quantize,
`StreamBuffer.push`, `oldest`, dequantize) batched over the streams.
Each is the median of --reps runs (the JAX tool's statistic), timed by
tools/profile_stages_torch.graph_time.  `serving_stages` is the function
chip_smoke.py calls in-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_stages_torch import noise, time_rows  # noqa: E402
from serving_torch import (  # noqa: E402
    append,
    card_line,
    check_json_out,
    parse_size,
    serving_filter,
)


def bodies(n_streams: int = 8, size: tuple[int, int] = (1080, 1920), device="cuda"):
    """(name, body, state) of each row (the module docstring)."""
    import torch
    import torch.utils._pytree as pytree

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer
    from livevisionkit_tpu_torch.ops import color
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter, batched
    from livevisionkit_tpu_torch.vision import frame_tracker

    dev = torch.device(device)
    fmt = lt.PixelFormat.YUV
    pix = noise((3, *size))
    batch = torch.stack([pix * (1.0 + 0.01 * i) for i in range(n_streams)]).to(dev)
    live = torch.ones(n_streams, dtype=torch.bool, device=dev)
    spec = lt.FrameSpec(*size, 3, fmt)
    base = serving_filter(size)

    def frames(t):
        return lt.Frame(pixels=batch + 1e-9 * t, timestamp=(t / 60.0).reshape(1).expand(n_streams),
                        valid=live, format=fmt)

    for wf in ("easu", "bilinear"):
        multi = MultiStreamFilter(lt.StabilizationFilter(
            settings=dataclasses.replace(base.settings, warp_filter=wf)), n_streams)

        def tick(st, t, multi=multi):
            return multi.step(st, frames(t))

        yield f"full step ({wf:8s})", tick, multi.init(spec, device=dev)

    s = base.settings

    def track(st, g):
        st, res = frame_tracker.track(st, g, s.tracker)
        return st, res.stability

    track_v = batched(track)

    def track_body(st, t):
        return track_v(st, batch[:, 0] + 1e-9 * t)

    tstate = pytree.tree_map(lambda x: torch.stack([x] * n_streams),
                             frame_tracker.init(s.tracker, device=dev))
    yield f"tracker.track (S={n_streams})", track_body, tstate

    def round_trip(q, px, ts, v):
        q = q.push({"pixels": color.to_u8(px), "timestamp": ts, "valid": v})
        return q, color.from_u8(q.oldest()["pixels"])

    round_trip_v = batched(round_trip)

    def queue_body(q, t):
        fr = frames(t)
        return round_trip_v(q, fr.pixels, fr.timestamp, fr.valid)

    template = {"pixels": torch.zeros((3, *size), dtype=torch.uint8, device=dev),
                "timestamp": torch.zeros((), dtype=torch.float32, device=dev),
                "valid": torch.zeros((), dtype=torch.bool, device=dev)}
    queue = pytree.tree_map(lambda x: torch.stack([x] * n_streams),
                            StreamBuffer.create(template, s.smoother.predictive_samples + 1))
    yield "queue quant/push/deq ", queue_body, queue


def serving_stages(n_streams: int = 8, size: tuple[int, int] = (1080, 1920), device="cuda",
                   n: int = 60, reps: int = 3) -> list[tuple[str, float]]:
    """The rows, (name, ms) in the JAX tool's order; a name is the text the
    JAX tool prints before its colon."""
    return time_rows(bodies(n_streams, size, device), n, reps, stat="median")


def main(argv=None) -> list[tuple[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("streams", nargs="?", type=int, default=8, help="S, the streams")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--n", type=int, default=60, help="replays a timed run")
    ap.add_argument("--reps", type=int, default=3, help="timed runs; the median is kept")
    ap.add_argument("--json-out", default=None, help="also append the rows to this file")
    args = ap.parse_args(argv)
    check_json_out(args.json_out)

    size = parse_size(args.size)
    card = card_line(args.device)
    print(f"backend: {card}  S={args.streams} {size[0]}x{size[1]}", flush=True)
    rows = serving_stages(args.streams, size, args.device, args.n, args.reps)
    for name, ms in rows:
        print(f"{name}: {ms:7.3f} ms", flush=True)
        append({"tool": "profile_serving_stages", "row": name.strip(), "ms": ms,
                "streams": args.streams, "device": card, "size": f"{size[0]}x{size[1]}"},
               args.json_out)
    return rows


if __name__ == "__main__":
    main()
