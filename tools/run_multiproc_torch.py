"""Cross-process multi-stream run of the PyTorch port (the counterpart of
tools/run_multiproc.py).

Spawns TWO worker processes that join one process group through
``torch.distributed`` (gloo, a ``file://`` rendezvous in a temporary
directory: no network, no port), lays a (4, 2) global ("stream", "tile")
mesh over their local devices rank-major (four each), and runs
``MultiHostStreamFilter`` in each, through its `jit_step` (a CUDA graph a
tick on the card): a worker feeds, steps and fetches only its own two
streams.  Then one process runs the same two ranks' parts in
turn, and every stream's output of every step must be BIT-EQUAL.

The reference of equality is one process running both parts, not one
4-stream tick: each process's rows share their devices, so they step as one
batched step with their own RANSAC generator, and a generator's draws
depend on how many streams share it (parallel/streams.py).

Usage:  python tools/run_multiproc_torch.py [--device cuda|cpu]   # spawn and compare
        python tools/run_multiproc_torch.py --worker K ...           # internal
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
N_LOCAL_DEVICES = 4
N_STREAMS = 4
N_TILES = 2
STEPS = 8
SIZE = (96, 128)
SEED = 0


def _make_frame_np(stream: int, t: int):
    """Deterministic synthetic frame (tools/run_multiproc.py's): a diagonal
    gradient pattern scrolling at a per-stream velocity."""
    import numpy as np

    h, w = SIZE
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    vx = 0.8 + 0.35 * stream
    vy = 0.5 - 0.2 * stream
    ph = 0.07 * (xx - vx * t) + 0.05 * (yy - vy * t)
    pat = 0.5 + 0.25 * np.sin(ph * 6.0) + 0.2 * np.cos(ph * 17.0 + stream)
    return pat.astype(np.float32)[None]  # (1, H, W)


def _filter():
    import livevisionkit_tpu_torch as lt

    return lt.StabilizationFilter(settings=lt.StabilizationFilterSettings(
        tracker=lt.FrameTrackerSettings(
            detection_size=(48, 64),
            detector=lt.FeatureDetectorSettings(grid_shape=(6, 8), fast_threshold_init=0.05),
            min_motion_samples=8,
            motion=lt.MotionEstimationSettings(hypotheses=64),
        ),
        smoother=lt.PathSmootherSettings(predictive_samples=2),
    ))


def _mesh(device: str):
    from livevisionkit_tpu_torch.parallel import multihost

    return multihost.make_global_mesh(N_STREAMS, N_TILES, local_devices=[device] * N_LOCAL_DEVICES,
                                      num_processes=N_PROC)


def _run(mesh, device: str, rank: int) -> dict:
    """Rank `rank`'s streams of the global mesh over STEPS frames: its
    outputs keyed by stream and step."""
    import numpy as np
    import torch

    import livevisionkit_tpu_torch as lt
    from livevisionkit_tpu_torch.parallel.multihost import MultiHostStreamFilter

    mhf = MultiHostStreamFilter(_filter(), mesh, rank=rank)
    local = mhf.local_streams()
    assert len(local) == N_STREAMS // N_PROC, local  # rank-major row ownership
    state = mhf.init(lt.FrameSpec(*SIZE, 1, lt.PixelFormat.GRAY), seed=SEED)
    step = mhf.jit_step()
    outs = {}
    for t in range(STEPS):
        pix = torch.from_numpy(np.stack([_make_frame_np(s, t) for s in local])).to(device)
        frames = lt.Frame(pixels=pix, timestamp=torch.full((len(local),), t / 30.0, device=device),
                          valid=torch.ones(len(local), dtype=torch.bool, device=device),
                          format=lt.PixelFormat.GRAY)
        state, out = step(state, mhf.put_frames(frames))
        for k, arr in zip(local, mhf.fetch(out)):
            outs[f"s{k}_t{t}"] = arr
    return outs


def worker(pid: int, rendezvous: str, device: str, out_path: str) -> None:
    import numpy as np
    import torch.distributed as dist

    from livevisionkit_tpu_torch.parallel import multihost

    multihost.initialize(rendezvous, N_PROC, pid)
    assert dist.get_world_size() == N_PROC and dist.get_rank() == pid
    outs = _run(_mesh(device), device, dist.get_rank())
    np.savez(out_path, **outs)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[worker {pid}] streams {sorted({k.split('_')[0] for k in outs})}: wrote {len(outs)} "
          f"outputs", flush=True)


def single(device: str, out_path: str) -> None:
    import numpy as np

    outs = {}
    mesh = _mesh(device)
    for rank in range(N_PROC):
        outs.update(_run(mesh, device, rank))
    np.savez(out_path, **outs)
    print(f"[single] wrote {len(outs)} outputs", flush=True)


def spawn_and_compare(device: str) -> int:
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="lvk_mp_") as tmp:
        rendezvous = f"file://{os.path.join(tmp, 'rendezvous')}"
        me = os.path.abspath(__file__)
        procs = []
        for pid in range(N_PROC):
            out = os.path.join(tmp, f"worker{pid}.npz")
            procs.append((subprocess.Popen(
                [sys.executable, me, "--worker", str(pid), "--rendezvous", rendezvous,
                 "--device", device, "--out", out], cwd=REPO), out))
        try:
            rcs = [p.wait(timeout=600) for p, _ in procs]
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            print(f"FAIL: workers exited {rcs}")
            return 1
        ref_out = os.path.join(tmp, "single.npz")
        if subprocess.run([sys.executable, me, "--single", "--device", device, "--out", ref_out],
                          cwd=REPO).returncode:
            print("FAIL: single-process reference failed")
            return 1
        ref = dict(np.load(ref_out))
        got = {}
        for _, out in procs:
            got.update(np.load(out))
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    worst = max(float(np.abs(got[k].astype(np.float64) - ref[k]).max()) for k in ref)
    print(f"compared {len(ref)} stream-steps on {device}; max |diff| = {worst}")
    if worst != 0.0:
        print("FAIL: cross-process outputs differ from the single-process run")
        return 1
    print(f"MULTIPROC OK: {N_PROC} processes x {N_LOCAL_DEVICES} devices == 1 process running "
          f"both ranks (bit-identical)")
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--rendezvous", default=None)
    ap.add_argument("--device", default="cuda", help="every local device of the mesh (repeated)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.rendezvous, args.device, args.out)
    elif args.single:
        single(args.device, args.out)
    else:
        sys.exit(spawn_and_compare(args.device))


if __name__ == "__main__":
    main()
