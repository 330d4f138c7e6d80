"""Pixel-format ingest codecs: host video formats <-> device YUV planes
(counterpart of livevisionkit_tpu/runtime/ingest.py).

Reference parity: the OBS plugin's FrameIngest subsystem (reference
Modules/OBS-Plugin/Interop/FrameIngest.cpp): one codec per pixel-format
family chosen by `Select` (:38-77) — planar I420/I422/I444 (`I4XXIngest`),
semi-planar NV12 (`NV12Ingest`), packed YUY2/UYVY (`P422Ingest`), and direct
Y800/BGR/RGBA (`DirectIngest`) — uploading planes in bulk, upsampling chroma
to full resolution, and merging to the packed working format
(upload_planes/split/merge, FrameIngest.cpp:145-217+).

The host only reshapes and strides the encoded bytes (numpy views, and the
native byte shuffles of runtime/native_host.py); every pixel transform
(normalization, chroma up/down-sampling, plane merge) is a tensor op on
the device the planes are uploaded to (`device`, the card by default).
Downloads compute on the frame's device and return host numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.runtime import native_host
from livevisionkit_tpu_torch.types import PixelFormat


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _norm_u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().cpu().numpy()


def _merge_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Upsample chroma planes to the luma's size and stack (3, H, W) float
    [0, 1]."""
    h, w = y.shape
    planes = [_norm_u8(y)]
    for c in (u, v):
        c = _norm_u8(c)
        if tuple(c.shape) != (h, w):
            c = resample.resize(c, (h, w), antialias=False)
        planes.append(c)
    return torch.stack(planes)


def _yuv_frame(y, u, v, ts, device, alpha=None) -> Frame:
    pixels = _merge_yuv(_upload(y, device), _upload(u, device), _upload(v, device))
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.YUV,
                        alpha=None if alpha is None else _norm_u8(_upload(alpha, device)))


def upload_i420(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    ts=0.0,
    alpha: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> Frame:
    """Planar 4:2:0 (also covers I422/I444: pass the planes as-is; chroma
    upsampling keys off the actual plane shapes, matching I4XXIngest's
    chroma-scaling table, FrameIngest.cpp:478-493).  `alpha` is the optional
    full-resolution alpha plane of the I40A/I42A/YUVA variants
    (FrameIngest.cpp:43-48)."""
    return _yuv_frame(y, u, v, ts, device, alpha=alpha)


# Alpha-bearing planar aliases (reference FrameIngest::Select, :43-48 —
# I40A/I42A/YUVA are I420/I422/I444 plus a full-res alpha plane).
def upload_i40a(y, u, v, a, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    return upload_i420(y, u, v, ts=ts, alpha=a, device=device)


upload_i42a = upload_i40a
upload_yuva = upload_i40a


def upload_ayuv(packed: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed 4:4:4 AYUV [A Y U V] (reference P444Ingest, FrameIngest.cpp:
    62-63, 676-686): one upload of the packed bytes and a channel mix on
    the device; the alpha plane is kept."""
    x = _norm_u8(_upload(packed, device)).permute(2, 0, 1)
    return Frame.create(x[1:4], timestamp=ts, fmt=PixelFormat.YUV, alpha=x[0])


def _from_packed4(hwc4: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 4) uint8 -> ((3, H, W) float colour, (H, W) fourth channel)."""
    x = _norm_u8(_upload(hwc4, device)).permute(2, 0, 1)
    return x[:3], x[3]


def upload_rgba(hwc: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed RGBA (reference DirectIngest VIDEO_FORMAT_RGBA -> RGB,
    FrameIngest.cpp:718-720; the reference drops alpha, we carry it)."""
    pixels, alpha = _from_packed4(hwc, device)
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.RGB, alpha=alpha)


def upload_bgra(hwc: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed BGRA -> BGR + alpha (DirectIngest, FrameIngest.cpp:721-723)."""
    pixels, alpha = _from_packed4(hwc, device)
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.BGR, alpha=alpha)


def upload_bgrx(hwc: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed BGRX -> BGR; the X byte carries no data and is dropped."""
    pixels, _ = _from_packed4(hwc, device)
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.BGR)


def upload_nv12(y: np.ndarray, uv: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Semi-planar 4:2:0: uv is (H/2, W/2, 2) interleaved (or (H/2, W))."""
    if uv.ndim == 2:
        uv = uv.reshape(uv.shape[0], uv.shape[1] // 2, 2)
    u, v = native_host.split_nv12(uv)
    return _yuv_frame(y, u, v, ts, device)


def upload_yuy2(packed: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed 4:2:2 YUYV: (H, W, 2) uint8 [Y0 U Y1 V ...] or (H, 2W)."""
    if packed.ndim == 2:
        packed = packed.reshape(packed.shape[0], packed.shape[1] // 2, 2)
    y, u, v = native_host.unpack_yuy2(packed)
    return _yuv_frame(y, u, v, ts, device)


def upload_uyvy(packed: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    """Packed 4:2:2 UYVY."""
    if packed.ndim == 2:
        packed = packed.reshape(packed.shape[0], packed.shape[1] // 2, 2)
    y, u, v = native_host.unpack_uyvy(packed)
    return _yuv_frame(y, u, v, ts, device)


def upload_gray(y: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    return Frame.create(_norm_u8(_upload(y, device))[None], timestamp=ts, fmt=PixelFormat.GRAY)


def upload_bgr(hwc: np.ndarray, ts=0.0, device: torch.device | str = "cuda") -> Frame:
    x = _norm_u8(_upload(hwc, device)).permute(2, 0, 1)
    return Frame.create(x, timestamp=ts, fmt=PixelFormat.BGR)


def _split(pixels: torch.Tensor, chroma_size: tuple[int, int]):
    """u8 egress planes: full-res luma + chroma resized (antialiased) to
    `chroma_size`."""
    y = _to_u8(pixels[0])
    u = _to_u8(resample.resize(pixels[1], chroma_size, antialias=True))
    v = _to_u8(resample.resize(pixels[2], chroma_size, antialias=True))
    return _host(y), _host(u), _host(v)


def download_i420(frame: Frame) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device YUV frame -> host I420 planes (chroma subsampled on the
    device), the reverse of the ingest (FrameIngest.cpp download path)."""
    if frame.format is not PixelFormat.YUV:
        raise ValueError(f"download_i420 needs a YUV frame, got {frame.format}")
    h, w = frame.size
    return _split(frame.pixels, (h // 2, w // 2))


def download_nv12(frame: Frame) -> tuple[np.ndarray, np.ndarray]:
    """Device YUV frame -> host NV12 (y (H,W), uv (H/2,W/2,2) interleaved):
    the download half of the reference's NV12Ingest
    (FrameIngest.cpp:145-217); chroma subsampled on the device, interleave
    on the host (native fast path)."""
    y, u, v = download_i420(frame)
    return y, native_host.interleave_nv12(u, v)


def download_yuy2(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 2) YUYV (reference P422Ingest
    download, FrameIngest.cpp:145-217): horizontal chroma subsample on the
    device, byte interleave on the host (native fast path)."""
    if frame.format is not PixelFormat.YUV:
        raise ValueError(f"download_yuy2 needs a YUV frame, got {frame.format}")
    h, w = frame.size
    return native_host.pack_yuy2(*_split(frame.pixels, (h, w // 2)))


def download_uyvy(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 2) UYVY."""
    if frame.format is not PixelFormat.YUV:
        raise ValueError(f"download_uyvy needs a YUV frame, got {frame.format}")
    h, w = frame.size
    return native_host.pack_uyvy(*_split(frame.pixels, (h, w // 2)))


def download_i40a(frame: Frame):
    """Device YUV frame -> host I40A planes (y, u, v, a).  Alpha is opaque
    (255) when the frame carries none — mirroring the reference's
    fill_plane(255) on download into alpha formats (FrameIngest.cpp:198+)."""
    y, u, v = download_i420(frame)
    if frame.alpha is not None:
        a = _host(_to_u8(frame.alpha))
    else:
        a = np.full(y.shape, 255, np.uint8)
    return y, u, v, a


def _alpha_or_opaque(frame: Frame) -> torch.Tensor:
    if frame.alpha is not None:
        return frame.alpha
    return torch.ones(frame.size, dtype=torch.float32, device=frame.device)


def download_ayuv(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 4) AYUV.  Carried alpha is written
    back; otherwise opaque, matching P444Ingest::to_obs which mixes the
    3-channel frame behind a constant-255 alpha (FrameIngest.cpp:690-703)."""
    if frame.format is not PixelFormat.YUV:
        raise ValueError(f"download_ayuv needs a YUV frame, got {frame.format}")
    planes = torch.cat([_alpha_or_opaque(frame)[None], frame.pixels])
    return _host(_to_u8(planes.permute(1, 2, 0)))


def download_rgba(frame: Frame) -> np.ndarray:
    """Device RGB/BGR frame -> packed (H, W, 4) RGBA/BGRA uint8 (alpha last
    for every Direct format, FrameIngest.cpp:747-753)."""
    if frame.format not in (PixelFormat.RGB, PixelFormat.BGR):
        raise ValueError(f"download_rgba needs an RGB or BGR frame, got {frame.format}")
    planes = torch.cat([frame.pixels, _alpha_or_opaque(frame)[None]])
    return _host(_to_u8(planes.permute(1, 2, 0)))


download_bgra = download_rgba
