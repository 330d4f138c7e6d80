"""`lvk-torch` command-line video editor (counterpart of
livevisionkit_tpu/runtime/cli.py, the `lvk` CLI, with the same grammar,
options, filter specs and outputs).

Reference parity: the VideoEditor CLI (reference Modules/VideoEditor/):
grammar ``lvk [opts] input [output] [opts]`` (VideoIOConfiguration.cpp:
200-221), options -h manual, -p profile-file expansion (:148-183), -f
filter spec (:272-296), -r fps, -c fourcc, -s display, -u update period,
-v verbose timings, -L CSV log (:299-405); filter registry `vs|stab`
(.crop_prop/.crop_out/.smoothing) and `adb|deblocker` (.levels) (:410-448),
extended here with the rest of the framework's filters (fsr, cas, lc,
conv) which the reference exposes through OBS instead.

Filter specs: ``-f NAME[.key=value]...`` e.g.
    lvk-torch -f vs.smoothing=15.crop_out=1 -f adb.levels=4 in.mp4 out.mp4

Differences from `lvk`: `--device` (default cuda) selects the torch device
where `lvk` reads JAX_PLATFORMS; `--trace DIR` writes a torch.profiler
Chrome trace; `--compile-cache` is accepted, so that a `-p` profile written
for `lvk` parses, and does nothing (there is no compilation cache).
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import dataclasses
import json
import sys
import time

from livevisionkit_tpu_torch import (
    CameraParameters,
    CASFilter,
    CASFilterSettings,
    CompositeFilter,
    ConversionFilter,
    DeblockingFilter,
    DeblockingFilterSettings,
    FrameTrackerSettings,
    LensCorrectionFilter,
    PathSmootherSettings,
    PixelFormat,
    ScalingFilter,
    ScalingFilterSettings,
    StabilizationFilter,
    StabilizationFilterSettings,
)


def _parse_filter_spec(spec: str):
    """NAME[.key=value]... -> (name, {key: value})."""
    parts = spec.split(".")
    name = parts[0].lower()
    opts = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
        else:
            k, v = p, "1"
        opts[k] = v
    return name, opts


def _build_filter(name: str, opts: dict[str, str]):
    def fget(k, default):
        return float(opts.get(k, default))

    def iget(k, default):
        return int(float(opts.get(k, default)))

    if name in ("vs", "stab"):
        from livevisionkit_tpu_torch.presets import stabilization_preset

        model = opts.get("model", "field" if "mesh" in opts else "homography")
        settings = stabilization_preset(
            model=model,
            qa=opts.get("qa", "default"),
            smoothing=iget("smoothing", 10),
            crop=fget("crop_prop", 0.10),
            crop_output=bool(iget("crop_out", 0)),
        )
        if "mesh" in opts:
            n = iget("mesh", 16)
            settings = dataclasses.replace(
                settings,
                tracker=dataclasses.replace(
                    settings.tracker, motion_resolution=(n, n)
                ),
            )
        return StabilizationFilter(
            settings=settings, debug=bool(iget("debug", 0))
        )
    if name in ("adb", "deblocker"):
        return DeblockingFilter(
            DeblockingFilterSettings(detection_levels=iget("levels", 3))
        )
    if name in ("fsr", "scale"):
        size = opts.get("size", "1920x1080")
        w, h = (int(v) for v in size.lower().split("x"))
        return ScalingFilter(
            ScalingFilterSettings(
                output_size=(h, w), sharpness=fget("sharpness", 0.8)
            )
        )
    if name in ("cas", "sharpen"):
        # Real AMD CAS (reference CASEffect/cas.effect), not an RCAS alias.
        return CASFilter(CASFilterSettings(sharpness=fget("sharpness", 0.8)))
    if name == "rcas":
        # FSR's RCAS alone (the reference only exposes it inside FSR).
        return ScalingFilter(
            ScalingFilterSettings(output_size=None, sharpness=fget("sharpness", 0.8))
        )
    if name == "lc":
        profile = opts.get("profile")
        if not profile:
            raise SystemExit("lc filter requires .profile=<json file>")
        with open(profile) as f:
            params = CameraParameters.from_dict(json.load(f))
        return LensCorrectionFilter(parameters=params, alpha=fget("alpha", 0.0))
    if name in ("conv", "convert"):
        extract = opts.get("extract")
        return ConversionFilter(
            PixelFormat(opts.get("format", "yuv")),
            extract_channel=int(extract) if extract is not None else None,
        )
    raise SystemExit(
        f"unknown filter {name!r} (try: vs, adb, fsr, cas, rcas, lc, conv)"
    )


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lvk-torch",
        description="TPU-native real-time video stabilization & enhancement "
        "(LiveVisionKit-TPU)",
    )
    p.add_argument(
        "input", nargs="?", help="input video file or capture-device index"
    )
    p.add_argument("output", nargs="?", help="output video file")
    p.add_argument(
        "-f",
        "--filter",
        dest="filters",
        action="append",
        default=[],
        metavar="SPEC",
        help="append filter: NAME[.key=val]... (vs, adb, fsr, cas, rcas, lc, conv)",
    )
    p.add_argument("-p", "--profile", help="file with extra CLI args, one per line")
    p.add_argument("-r", "--fps", type=float, help="override output frame rate")
    p.add_argument("-c", "--codec", default="", help="fourcc for the encoder")
    p.add_argument("-n", "--frames", type=int, help="process at most N frames")
    p.add_argument(
        "-v", "--verbose", action="store_true", help="print per-run timing stats"
    )
    p.add_argument(
        "--profile-filters", action="store_true",
        help="time each filter separately (syncs per filter; slower)",
    )
    p.add_argument(
        "--hud", type=float, default=None, metavar="BUDGET_MS",
        help="test-mode frame-time HUD stamped on outputs, green within "
        "BUDGET_MS / red over (reference VSFilter.cpp:368-383; its "
        "stabilizer budget is 6.0)",
    )
    p.add_argument("-L", "--log-csv", help="write frame timings to CSV")
    p.add_argument(
        "--trace", metavar="DIR",
        help="capture a torch.profiler trace (host spans and, on a CUDA "
        "device, its kernels) into DIR/trace.json (view with Perfetto); "
        "combine with --profile-filters for per-filter scopes",
    )
    p.add_argument(
        "-C", "--list-encoders", action="store_true",
        help="list available encoders (fourcc) and exit",
    )
    p.add_argument(
        "-s", "--show", action="store_true",
        help="display output frames in a window (needs a GUI backend)",
    )
    p.add_argument(
        "-S", "--show-fps", type=float, metavar="FPS",
        help="display output frames rate-locked to FPS",
    )
    p.add_argument(
        "-u", "--update-period", type=float, default=0.5,
        help="progress update period seconds",
    )
    p.add_argument(
        "--compile-cache", metavar="DIR",
        help="accepted for `lvk` profiles; has no effect (no compilation cache)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run the filters on (default: cuda)",
    )
    return p


def expand_profile(argv: list[str]) -> list[str]:
    """-p FILE inserts the file's whitespace-separated args in place
    (reference VideoIOConfiguration.cpp:148-183)."""
    out = []
    i = 0
    while i < len(argv):
        if argv[i] in ("-p", "--profile") and i + 1 < len(argv):
            with open(argv[i + 1]) as f:
                out.extend(f.read().split())
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


def main(argv: list[str] | None = None) -> int:
    from livevisionkit_tpu_torch.runtime import video_io
    from livevisionkit_tpu_torch.runtime.stream import stream

    argv = expand_profile(list(sys.argv[1:] if argv is None else argv))
    args = make_parser().parse_args(argv)

    # SIGINT -> graceful stop: drain in-flight frames and finalize the output
    # file instead of dying mid-write (reference Application.cpp:45-52).
    import os
    import signal
    import threading

    stop_event = threading.Event()
    try:
        signal.signal(signal.SIGINT, lambda *_: stop_event.set())
    except ValueError:
        pass  # not on the main thread (embedded use)
    # Processing priority boost, best effort (reference Application.cpp:67-72
    # uses nice(-40)/HIGH_PRIORITY_CLASS); unprivileged processes can't raise
    # priority, so failure is expected and silent.
    try:
        os.nice(-5)
    except (OSError, AttributeError):
        pass

    if args.list_encoders:
        for fourcc, ok in video_io.list_encoders():
            print(f"{fourcc:8s} {'available' if ok else 'unavailable'}")
        return 0
    if args.input is None:
        make_parser().error("input is required (or use -C to list encoders)")

    filters = [_build_filter(*_parse_filter_spec(s)) for s in args.filters]
    filt = CompositeFilter(filters=tuple(filters)) if filters else CompositeFilter(
        filters=()
    )

    src = int(args.input) if args.input.isdigit() else args.input
    reader = video_io.VideoReader(src)
    fps = args.fps or reader.meta.fps
    writer = video_io.VideoWriter(args.output, fps, args.codec) if args.output else None

    total = reader.meta.frame_count
    t_start = time.perf_counter()
    last_update = [0.0]
    written = [0]

    from livevisionkit_tpu_torch.utils.profiling import TickTimer

    if args.show_fps:
        args.show = True
    show_ok = [args.show]
    show_timer = TickTimer()
    if args.show and not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        # cv2.imshow aborts the process (Qt) when no display server exists,
        # so this must be gated up front rather than caught.
        print("no display server; -s/--show disabled", file=sys.stderr)
        show_ok[0] = False

    def on_output(planar_bgr, ts):
        hwc = None
        if writer is not None:
            hwc = video_io.encode_bgr(planar_bgr)
            writer.write(hwc)
        if show_ok[0] and (
            not args.show_fps or show_timer.tick(1.0 / args.show_fps)
        ):
            # Display window with escape-to-quit (reference
            # VideoProcessor.cpp:184-211); -S rate-locks via TickTimer.
            try:
                import cv2

                if hwc is None:
                    hwc = video_io.encode_bgr(planar_bgr)
                cv2.imshow("lvk", hwc)
                if (cv2.waitKey(1) & 0xFF) == 27:
                    raise KeyboardInterrupt
            except KeyboardInterrupt:
                raise
            except Exception as e:
                print(f"\ndisplay unavailable ({e}); continuing", file=sys.stderr)
                show_ok[0] = False
        written[0] += 1
        now = time.perf_counter()
        if now - last_update[0] > args.update_period:
            last_update[0] = now
            el = now - t_start
            fps_now = written[0] / el if el > 0 else 0.0
            msg = f"\r{written[0]} frames  {fps_now:6.1f} fps"
            if total:
                pct = 100.0 * written[0] / total
                eta = (total - written[0]) / fps_now if fps_now > 0 else 0
                msg += f"  {pct:5.1f}%  ETA {eta:6.1f}s"
            print(msg, end="", file=sys.stderr, flush=True)

    from livevisionkit_tpu_torch.utils.profiling import DeviceTrace

    with DeviceTrace(args.trace, device=args.device):
        stats = stream(
            filt, reader, on_output=on_output, max_frames=args.frames,
            profile_filters=args.profile_filters, stop_event=stop_event,
            hud_budget_ms=args.hud, device=args.device,
        )
    if args.trace:
        print(f"device trace written to {os.path.join(args.trace, 'trace.json')}",
              file=sys.stderr)

    elapsed = time.perf_counter() - t_start
    print(file=sys.stderr)
    print(
        f"done: {stats.frames_in} in / {stats.frames_out} out, "
        f"{elapsed:.2f}s ({stats.frames_out / elapsed if elapsed > 0 else 0:.1f} fps)",
        file=sys.stderr,
    )
    if args.verbose:
        ft = stats.frame_time
        print(
            f"frame time: {ft.average_ms():.2f} ms ± {ft.deviation_ms():.2f} ms "
            f"(n={ft.count})",
            file=sys.stderr,
        )
        for name, watch in stats.filter_times.items():
            print(
                f"  {name}: {watch.average_ms():.2f} ms ± "
                f"{watch.deviation_ms():.2f} ms",
                file=sys.stderr,
            )
        print("spans: count, median ms, p95 ms", file=sys.stderr)
        for name, n, median_ms, p95_ms in stats.session.table():
            print(f"  {name}: {n}, {median_ms:.3f}, {p95_ms:.3f}", file=sys.stderr)
    if args.log_csv:
        # Aggregate run metrics followed by per-filter average ± deviation
        # rows (the reference's -L CSV timing log writes one avg/dev block
        # per filter, VideoProcessor.cpp:312-356; per-filter rows need
        # --profile-filters since unsynced filters aren't individually
        # timeable inside one fused device program).
        with open(args.log_csv, "w", newline="") as f:
            wr = csv_mod.writer(f)
            wr.writerow(["metric", "name", "avg_ms", "dev_ms", "count"])
            wr.writerow(["frames_in", "", "", "", stats.frames_in])
            wr.writerow(["frames_out", "", "", "", stats.frames_out])
            wr.writerow(["wall_s", "", f"{elapsed:.4f}", "", ""])
            ft = stats.frame_time
            wr.writerow([
                "frame_time", "<total>", f"{ft.average_ms():.4f}",
                f"{ft.deviation_ms():.4f}", ft.count,
            ])
            for name, watch in stats.filter_times.items():
                wr.writerow([
                    "filter_time", name, f"{watch.average_ms():.4f}",
                    f"{watch.deviation_ms():.4f}", watch.count,
                ])
    if writer is not None:
        writer.close()
    reader.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
