"""Host-side video ingest/egress (counterpart of
livevisionkit_tpu/runtime/video_io.py).

Reference parity: the CLI's cv::VideoCapture / cv::VideoWriter front-end
(reference Modules/VideoEditor/VideoProcessor.cpp:38-91 input open with
FFmpeg backend, :172-181 lazy writer init).  The upload half of ingest is
runtime/stream.py's (a pinned host buffer, a non-blocking copy and an
on-device repack), so the host only ever touches encoded I/O buffers.

OpenCV is used STRICTLY for container decode/encode, and is optional: the
package imports without it (a host without OpenCV drives `stream()` from
in-memory readers), and a reader or writer built without it raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

try:  # host decode/encode only
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


@dataclass
class VideoMeta:
    width: int
    height: int
    fps: float
    frame_count: int  # 0 if unknown/live


class VideoReader:
    """Iterates (bgr_uint8_hwc, timestamp_seconds)."""

    def __init__(self, path: str | int):
        if not _HAS_CV2:
            raise RuntimeError("cv2 unavailable: no video decode backend")
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video source {path!r}")
        self.meta = VideoMeta(
            width=int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(self.cap.get(cv2.CAP_PROP_FPS) or 30.0),
            frame_count=max(int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0),
        )
        self._t = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, float]]:
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            ts = self._t / self.meta.fps
            self._t += 1
            yield frame, ts

    def close(self):
        self.cap.release()


class VideoWriter:
    """Lazily-opened writer (VideoProcessor.cpp:172-181 semantics)."""

    def __init__(self, path: str, fps: float, fourcc: str = ""):
        if not _HAS_CV2:
            raise RuntimeError("cv2 unavailable: no video encode backend")
        self.path = path
        self.fps = fps
        self.fourcc = fourcc or self._default_fourcc(path)
        self._writer = None

    @staticmethod
    def _default_fourcc(path: str) -> str:
        ext = os.path.splitext(path)[1].lower()
        return {"avi": "MJPG", ".avi": "MJPG", ".mkv": "mp4v"}.get(ext, "mp4v")

    def write(self, bgr_uint8_hwc: np.ndarray):
        if self._writer is None:
            h, w = bgr_uint8_hwc.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*self.fourcc), self.fps, (w, h)
            )
            if not self._writer.isOpened():
                raise RuntimeError(
                    f"cannot open video writer {self.path!r} ({self.fourcc})"
                )
        self._writer.write(bgr_uint8_hwc)

    def close(self):
        if self._writer is not None:
            self._writer.release()


def list_encoders() -> list[tuple[str, bool]]:
    """Probe which fourcc encoders the host backend can open (reference
    VideoIOConfiguration.cpp `-C` encoder listing).  Returns
    [(fourcc, available)] for a candidate set of common codecs."""
    if not _HAS_CV2:
        return []
    import tempfile

    candidates = [
        ("mp4v", ".mp4"), ("avc1", ".mp4"), ("H264", ".mp4"),
        ("hev1", ".mp4"), ("MJPG", ".avi"), ("XVID", ".avi"),
        ("FFV1", ".avi"), ("VP80", ".webm"), ("VP90", ".webm"),
        ("png ", ".avi"), ("I420", ".avi"),
    ]
    out = []
    prev_level = None
    try:  # silence FFmpeg "codec not found" chatter during probing
        prev_level = cv2.utils.logging.getLogLevel()
        cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    except Exception:
        pass
    for fourcc, ext in candidates:
        with tempfile.NamedTemporaryFile(suffix=ext) as f:
            w = cv2.VideoWriter(
                f.name, cv2.VideoWriter_fourcc(*fourcc), 30.0, (64, 64)
            )
            ok = w.isOpened()
            w.release()
        out.append((fourcc.strip(), ok))
    if prev_level is not None:
        try:
            cv2.utils.logging.setLogLevel(prev_level)
        except Exception:
            pass
    return out


def encode_bgr(planar_float: np.ndarray) -> np.ndarray:
    """(3, H, W) float [0,1] BGR planes -> HWC uint8 for the encoder
    (native C++ quantize+interleave when available)."""
    from livevisionkit_tpu_torch.runtime import native_host

    return native_host.planar_f32_to_hwc_u8(np.asarray(planar_float))
