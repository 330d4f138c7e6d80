"""Multi-device dry run (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): one step of each multi-device path
over a mesh of `n_devices` devices, which may repeat (``["cpu"] * 8`` in the
CPU tests, ``cuda:0`` four times on one card).

    python -m livevisionkit_tpu_torch.parallel.dryrun [N] [--device cpu] [--uhd HxW]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from livevisionkit_tpu_torch.config import MeshMotionSettings
from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import CompositeFilter, FrameSpec
from livevisionkit_tpu_torch.filters.deblocking import DeblockingFilter
from livevisionkit_tpu_torch.filters.sharpening import CASFilter
from livevisionkit_tpu_torch.filters.stabilization import flagship_filter
from livevisionkit_tpu_torch.models.homography import Homography
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.parallel import distributed_solve, spatial
from livevisionkit_tpu_torch.parallel import streams as par
from livevisionkit_tpu_torch.types import PixelFormat

GRAY = PixelFormat.GRAY


def tiny_flagship():
    """The flagship's settings cut to the dry run's tiny tracker (the JAX
    dry run's): 48x64 detection, a 4x4 grid, a 2-frame window."""
    return flagship_filter(detection=(48, 64), grid=(4, 4), predictive=2, min_samples=6,
                           hypotheses=32)


def _frames(pixels: torch.Tensor) -> Frame:
    """A stacked GRAY frame batch at time 0, built on the pixels' device."""
    n, dev = pixels.shape[0], pixels.device
    return Frame(pixels=pixels, timestamp=torch.zeros(n, device=dev),
                 valid=torch.ones(n, dtype=torch.bool, device=dev), format=GRAY)


def dryrun_multichip(n_devices: int, devices=None, size=(96, 128), uhd=(2160, 3840)) -> dict:
    """One step of each multi-device path, shapes checked:

      * the tiny flagship over a ("stream", "tile") mesh (2 tiles when
        `n_devices` is even) at `size`;
      * the distributed WarpField solve over a 1-D "tile" mesh of all the
        devices (16 features a device, a 5x5 field);
      * the `vs + adb + cas` chain over a 1 x n_devices tile mesh at `uhd`;
      * the EASU halo remap (`remap_sharded`, halo 192) of a `uhd` frame.

    `devices` (n_devices of them, repeats allowed) defaults to the distinct
    CUDA cards.  Returns each path's inputs and outputs."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    first = devices[0]
    rng = np.random.default_rng(0)
    n_tiles = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_streams = n_devices // n_tiles
    mesh = par.make_mesh(n_streams, n_tiles, devices)

    h, w = size
    ms = par.MultiStreamFilter(tiny_flagship(), n_streams, mesh)
    states = ms.init(FrameSpec(height=h, width=w, channels=1, format=GRAY))
    pixels = torch.from_numpy(rng.uniform(size=(n_streams, 1, h, w)).astype(np.float32)).to(first)
    states, out = ms.step(states, ms._shard(_frames(pixels), tile_w=True))
    out = par.unshard(out, first)
    assert out.pixels.shape == (n_streams, 1, h, w), out.pixels.shape

    n_feats = 16 * n_devices
    src = torch.from_numpy(rng.uniform(4, 90, size=(n_feats, 2)).astype(np.float32)).to(first)
    dst = src + torch.from_numpy(rng.uniform(-1, 1, size=(n_feats, 2)).astype(np.float32)).to(first)
    solve_mesh = par.Mesh(devices, ("tile",))
    fld, _, _ = distributed_solve.estimate_sharded(
        src, dst, torch.ones(n_feats, device=first), WarpField.identity((5, 5), device=first),
        (96, 128), MeshMotionSettings(cg_iterations=8, irls_rounds=1), solve_mesh)
    assert fld.offsets.shape == (2, 5, 5), fld.offsets.shape

    mesh4k = par.make_mesh(1, n_devices, devices)
    h4, w4 = uhd
    chain = CompositeFilter((tiny_flagship(), DeblockingFilter(), CASFilter()))
    ms4 = par.MultiStreamFilter(chain, 1, mesh4k)
    states4 = ms4.init(FrameSpec(height=h4, width=w4, channels=1, format=GRAY))
    px4 = torch.from_numpy(rng.uniform(size=(1, 1, h4, w4)).astype(np.float32)).to(first)
    frames4 = _frames(px4)
    states4, out4 = ms4.step(states4, ms4._shard(frames4, tile_w=True))
    out4 = par.unshard(out4, first)
    assert out4.pixels.shape == (1, 1, h4, w4), out4.pixels.shape

    # The explicit halo-exchange remap, the program that tile-shards a warp
    # (halo 192 covers the corrective limit's reach at 4K).
    f = lambda v: torch.full((), v, device=first)  # noqa: E731
    smap4 = Homography.from_similarity(f(1.001), f(0.002), f(5.0), f(-3.0)).sample_map((h4, w4))
    out_sh = spatial.remap_sharded(px4[0], smap4, mesh4k, halo=192, filter_mode="easu", fmt=GRAY)
    assert out_sh.shape == (1, h4, w4), out_sh.shape

    print(f"dryrun_multichip OK: mesh={mesh.shape} on {sorted(set(map(str, devices)))}, "
          f"out={tuple(out.pixels.shape)}, distributed solve field={tuple(fld.offsets.shape)}, "
          f"{h4}x{w4} chain mesh={mesh4k.shape} out={tuple(out4.pixels.shape)}, "
          f"halo remap={tuple(out_sh.shape)} (halo 192)", flush=True)
    return {"mesh": mesh, "out": out, "field": fld, "chain": chain, "chain_frames": frames4,
            "chain_out": out4, "remap_in": (px4[0], smap4, mesh4k), "remap_out": out_sh}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", help="the device every mesh entry repeats")
    ap.add_argument("--uhd", default="2160x3840", help="the chain's and the remap's HxW")
    args = ap.parse_args()
    uhd = tuple(int(v) for v in args.uhd.split("x"))
    dryrun_multichip(args.n_devices, [args.device] * args.n_devices, uhd=uhd)


if __name__ == "__main__":
    main()
