"""The port's entry points run on the card unless the caller asks for the
CPU: each takes `device="cuda"` by default, and the CPU tests pass
`device="cpu"`.  Whether this host has a card is decided inside the test."""

import inspect

import pytest
import torch

import livevisionkit_tpu_torch as lvt
from livevisionkit_tpu_torch.filters.base import CompositeFilter, VideoFilter
from livevisionkit_tpu_torch.filters.lens_correction import LensCorrectionFilter
from livevisionkit_tpu_torch.filters.stabilization import StabilizationFilter
from livevisionkit_tpu_torch.models.quad import Quad
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.ops import remap
from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter
from livevisionkit_tpu_torch.runtime import calibrate_cli, cli, ingest
from livevisionkit_tpu_torch.runtime.multistream import stream_multi
from livevisionkit_tpu_torch.runtime.offline import process_clip
from livevisionkit_tpu_torch.runtime.stream import stream
from livevisionkit_tpu_torch.utils.profiling import DeviceTrace
from livevisionkit_tpu_torch.vision import features, frame_tracker, path_smoother
from livevisionkit_tpu_torch.vision.calibration import undistort_field

ENTRY_POINTS = {
    "VideoFilter.init": VideoFilter.init,
    "CompositeFilter.init": CompositeFilter.init,
    "StabilizationFilter.init": StabilizationFilter.init,
    "MultiStreamFilter.init": MultiStreamFilter.init,
    "stream_multi": stream_multi,
    "frame_tracker.init": frame_tracker.init,
    "path_smoother.init": path_smoother.init,
    "features.initial_thresholds": features.initial_thresholds,
    "WarpField.identity": WarpField.identity,
    "Quad.from_rect": Quad.from_rect,
    "remap.identity_map": remap.identity_map,
    "stream": stream,
    "process_clip": process_clip,
    "undistort_field": undistort_field,
    "LensCorrectionFilter.init": LensCorrectionFilter.init,
    "DeviceTrace": DeviceTrace,
    **{f"ingest.{name}": getattr(ingest, name) for name in dir(ingest) if name.startswith("upload_")},
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_every_upload_is_listed():
    assert {n for n in ENTRY_POINTS if n.startswith("ingest.")} >= {
        f"ingest.upload_{f}" for f in ("i420", "i40a", "ayuv", "rgba", "bgra", "bgrx", "nv12",
                                        "yuy2", "uyvy", "gray", "bgr")}


@pytest.mark.parametrize("parser", [cli.make_parser, calibrate_cli.make_parser])
def test_cli_device_default_is_the_card(parser):
    """`lvk-torch --device` and `lvk-calibrate --device` default to cuda."""
    assert parser().parse_args(["in.mp4", "out.json"]).device == "cuda"


def test_stabilizer_init_default_is_the_card():
    """With a card the default state lies on it; without one, `init` with
    the default raises rather than building CPU state."""
    spec = lvt.FrameSpec(64, 96, 3, lvt.PixelFormat.YUV)
    filt = lvt.flagship_filter()
    if torch.cuda.is_available():
        assert filt.init(spec).correction.offsets.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            filt.init(spec)
    assert filt.init(spec, device="cpu").correction.offsets.device.type == "cpu"
