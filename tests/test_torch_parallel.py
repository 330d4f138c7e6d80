"""Port parity of the multi-device layer, on meshes of repeated CPU devices
(``["cpu"] * n``: the port's meshes are lists of torch devices, so no
virtual-device flag is needed).

* `make_mesh`, `_spec_for_leaf` and the placement of `_shard` against the
  JAX package's mesh and partition specs, and `MultiStreamFilter` over an
  (S, 1) and an (S/2, 2) mesh bit-equal to the meshless tick.
* `remap_sharded` (halo exchange, the per-tile warp's plain version)
  against the JAX package's unsharded `ops.remap.remap`.
* `estimate_sharded` against the JAX package's `mesh_motion.estimate` and
  the port's own solo solve, features padded where they do not divide.
* The degenerate single-process `multihost` functions, and one process
  running another rank's part of a two-process mesh.
* `dryrun_multichip(8)` at its small size; the two-process tool (slow).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
import livevisionkit_tpu_torch as lt
from livevisionkit_tpu import config as jcfg
from livevisionkit_tpu.models.homography import Homography as JH
from livevisionkit_tpu.models.warp_field import WarpField as JWF
from livevisionkit_tpu.ops import remap as jremap
from livevisionkit_tpu.parallel import multihost as jmultihost
from livevisionkit_tpu.parallel import streams as jstreams
from livevisionkit_tpu.vision import mesh_motion as jmm
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.models.warp_field import WarpField as TWF
from livevisionkit_tpu_torch.ops import remap as tremap
from livevisionkit_tpu_torch.parallel import distributed_solve, dryrun, multihost, spatial
from livevisionkit_tpu_torch.parallel import streams as par
from livevisionkit_tpu_torch.vision import mesh_motion as tmm

GRAY = lt.PixelFormat.GRAY
SIZE = (96, 128)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(n):
    return ["cpu"] * n


def _tiles(n):
    return par.Mesh(_cpus(n), ("tile",))


# ------------------------------------------------------------ mesh, placement


def test_make_mesh_shape_matches_jax():
    """The (stream, tile) grid and its axis names as in the JAX package;
    too few devices raise, and with no CUDA card the default mesh raises
    rather than fall back to the CPU."""
    mesh = par.make_mesh(2, 4, _cpus(8))
    jmesh = jstreams.make_mesh(2, 4)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices.shape == jmesh.devices.shape
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="need 9 devices"):
        par.make_mesh(3, 3, _cpus(8))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            par.make_mesh(1)


@pytest.mark.parametrize("shape", [(4, 1, 96, 128), (4, 3, 96, 128), (4, 96, 128), (4, 1, 96, 63),
                                   (4, 10, 3, 96, 128), (4, 2, 2, 2), (4, 510, 2), (4,)])
@pytest.mark.parametrize("tile_w", [False, True])
def test_spec_for_leaf_matches_jax(shape, tile_w):
    """Which leaves split along W: the JAX package's PartitionSpec, axis for
    axis."""
    want = tuple(jstreams._spec_for_leaf(jnp.zeros(shape), tile_w))
    assert par._spec_for_leaf(torch.zeros(shape), tile_w) == want


def _stacked_frames(rng, n_streams, size=SIZE):
    px = torch.from_numpy(rng.uniform(size=(n_streams, 1, *size)).astype(np.float32))
    return lt.Frame(pixels=px, timestamp=torch.arange(n_streams, dtype=torch.float32) / 30.0,
                    valid=torch.ones(n_streams, dtype=torch.bool), format=GRAY)


def test_shard_places_streams_and_w_stripes():
    """One group for rows that share their devices; large image leaves split
    into one W stripe per tile (views: the devices repeat), small leaves
    whole; `unshard` gives the stacked tree back bit for bit."""
    frames = _stacked_frames(np.random.default_rng(0), 2)
    ms = par.MultiStreamFilter(dryrun.tiny_flagship(), 2, par.make_mesh(2, 4, _cpus(8)))
    shards = ms._shard(frames, tile_w=True)
    assert len(shards) == 1 and shards[0].streams == (0, 1)
    px = shards[0].tree.pixels
    assert isinstance(px, par.Stripes) and [p.shape for p in px.parts] == [(2, 1, 96, 32)] * 4
    assert px.parts[1].data_ptr() == frames.pixels[..., 32:].data_ptr()
    assert isinstance(shards[0].tree.timestamp, torch.Tensor)
    back = par.unshard(shards, "cpu")
    assert torch.equal(back.pixels, frames.pixels) and torch.equal(back.timestamp, frames.timestamp)
    untiled = ms._shard(frames, tile_w=False)[0].tree.pixels
    assert isinstance(untiled, torch.Tensor)
    # A state's queue is striped by init (the JAX test_tiled_frames_have_sharded_layout).
    states = ms.init(lt.FrameSpec(*SIZE, 1, GRAY), seed=0)
    assert isinstance(states[0].tree.frames.data["pixels"], par.Stripes)


def test_shard_streams_split_over_rows():
    with pytest.raises(ValueError, match="do not split"):
        par.MultiStreamFilter(dryrun.tiny_flagship(), 3, par.make_mesh(2, 1, _cpus(2)))


def _clip(rng, n_streams, n_frames, size=SIZE):
    out = []
    for _ in range(n_streams):
        base = fixtures.make_texture(256, 256, rng)
        poses, _ = fixtures.shaky_path(n_frames, rng, margin=60.0, shake_px=2.0)
        out.append(np.stack([np.asarray(fixtures.render_frame(base, p, size)) for p in poses]))
    return torch.from_numpy(np.stack(out)[:, :, None].astype(np.float32))  # (S, T, 1, H, W)


def test_multistream_mesh_matches_meshless():
    """A mesh whose rows share their devices steps as the meshless tick:
    outputs and every state tensor bit-equal over an (S, 1) and an
    (S/2, 2) tile mesh, the drain flags reaching each stream."""
    n_streams, n_frames = 4, 4
    clip = _clip(np.random.default_rng(1), n_streams, n_frames)
    filt = dryrun.tiny_flagship()
    spec = lt.FrameSpec(*SIZE, 1, GRAY)
    runs = {}
    for name, mesh in (("none", None), ("S x 1", par.make_mesh(4, 1, _cpus(4))),
                       ("S/2 x 2", par.make_mesh(2, 2, _cpus(4)))):
        ms = par.MultiStreamFilter(filt, n_streams, mesh)
        states = ms.init(spec, device="cpu", seed=3)
        for t in range(n_frames):
            frames = lt.Frame(pixels=clip[:, t], timestamp=torch.full((n_streams,), t / 30.0),
                              valid=torch.ones(n_streams, dtype=torch.bool), format=GRAY)
            drain = torch.tensor([False, False, False, t == n_frames - 1])
            states, out = ms.step(states, frames, drain)
        if mesh is not None:
            states, out = par.unshard(states, "cpu"), par.unshard(out, "cpu")
        runs[name] = (states, out)
    flat = {k: torch.utils._pytree.tree_leaves(v) for k, v in runs.items()}
    for name in ("S x 1", "S/2 x 2"):
        assert len(flat[name]) == len(flat["none"])
        for a, b in zip(flat[name], flat["none"]):
            assert torch.equal(a, b), name
    assert bool(runs["none"][1].valid.all())


# ------------------------------------------------------------ remap_sharded


def _remap_case(name, rng):
    """(image, map, fill, halo, mode) of the JAX package's sharded-remap
    tests (tests/test_spatial_sharding.py), at 96x512 / 64x512."""
    if name == "field":
        img = np.array(fixtures.make_texture(64, 512, rng))[None]
        off = np.zeros((2, 5, 9), np.float32)
        off[0] = 0.02 * np.sin(np.linspace(0, 3, 5))[:, None]
        off[1] = 0.03 * np.cos(np.linspace(0, 2, 9))[None, :]
        smap = np.array(JWF(offsets=jnp.asarray(off)).sample_map((64, 512)))
        return img, smap, 0.0, 32, "bilinear"
    img = np.stack([np.array(fixtures.make_texture(96, 512, rng)) for _ in range(3)])
    pose = (1.0, 0.0, 37.0, -12.0) if name == "translation" else (1.002, 0.004, 7.0, -3.0)
    smap = np.array(JH.from_similarity(*map(jnp.float32, pose)).sample_map((96, 512)))
    return img, smap, 0.25, 48, "bilinear" if name == "translation" else "easu"


@pytest.mark.parametrize("name", ["translation", "field", "easu"])
def test_remap_sharded_matches_jax_unsharded(name):
    """Eight tiles with halo exchange against the JAX package's unsharded
    XLA remap, atol 1e-5 (the bound test_spatial_sharding.py holds JAX's own
    sharded remap to), the EASU border ring included; the u8 image within
    1 LSB of the port's unsharded remap on at most 1e-3 of pixels."""
    img, smap, fill, halo, mode = _remap_case(name, np.random.default_rng(42))
    want = np.asarray(jremap.remap(jnp.asarray(img), jnp.asarray(smap), fill=fill, filter_mode=mode))
    got = spatial.remap_sharded(torch.from_numpy(img), torch.from_numpy(smap), _tiles(8), fill=fill,
                                halo=halo, filter_mode=mode)
    assert got.shape == img.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    img_u8 = torch.from_numpy(np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
    got_u8 = spatial.remap_sharded(img_u8, torch.from_numpy(smap), _tiles(8), fill=64.0, halo=halo,
                                   filter_mode=mode)
    ref_u8 = tremap.remap(img_u8, torch.from_numpy(smap), fill=64.0, filter_mode=mode)
    d = (got_u8.int() - ref_u8.int()).abs()
    assert got_u8.dtype == torch.uint8 and int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


def test_remap_sharded_one_tile_is_remap():
    """One tile is the whole frame, with no halo: the unsharded warp, bit
    for bit."""
    img, smap, fill, _, mode = _remap_case("easu", np.random.default_rng(7))
    img, smap = torch.from_numpy(img), torch.from_numpy(smap)
    got = spatial.remap_sharded(img, smap, _tiles(1), fill=fill, filter_mode=mode)
    assert torch.equal(got, tremap.remap(img, smap, fill=fill, filter_mode=mode))


def test_remap_sharded_rejects_bad_meshes():
    img, smap = torch.zeros((1, 8, 96)), torch.zeros((2, 8, 96))
    with pytest.raises(ValueError, match="must divide"):
        spatial.remap_sharded(img, smap, _tiles(5))
    with pytest.raises(ValueError, match="mixes device types"):
        spatial.remap_sharded(img, smap, par.Mesh(["cpu", "cuda:0"], ("tile",)))
    with pytest.raises(ValueError, match="filter_mode"):
        spatial.remap_sharded(img, smap, _tiles(2), filter_mode="cubic")


# ------------------------------------------------------------ the solve

SOLVE_SIZE = (96, 120)
SOLVE_MESH = (9, 11)


def _solve_problem(rng, n=320):
    """tests/test_distributed_solve.py's problem: a smooth ground-truth
    field, 320 features, 40 gross outliers."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_mesh_motion import _field_displacement, _make_gt_field

    gt = _make_gt_field()
    pts = np.stack([rng.uniform(2, SOLVE_SIZE[1] - 3, n), rng.uniform(2, SOLVE_SIZE[0] - 3, n)],
                   -1).astype(np.float32)
    src = pts + np.asarray(_field_displacement(pts, gt))[:, ::-1]
    bad = rng.choice(n, 40, replace=False)
    src[bad] += rng.uniform(6, 15, size=(40, 2))
    return src.astype(np.float32), pts, np.ones(n, np.float32)


@pytest.mark.parametrize("n_feats,n_dev", [(320, 8), (318, 4)])
def test_estimate_sharded_matches_jax_and_solo(n_feats, n_dev):
    """Features split over the tile devices (318 over 4 padded with
    zero-weight features): offsets within 1e-3 detection px of the JAX
    package's single-device solve (the port's estimate bound,
    test_torch_mesh.py) and within 1e-4 px of the port's own solo solve,
    whose inliers and mean residual (1e-5 px) it matches."""
    src, dst, w = _solve_problem(np.random.default_rng(42))
    src, dst, w = src[:n_feats], dst[:n_feats], w[:n_feats]
    kw = dict(temporal_weight=0.01, rigidity_weight=0.3, irls_rounds=2)
    scale = np.array([SOLVE_SIZE[0] - 1, SOLVE_SIZE[1] - 1], np.float32).reshape(2, 1, 1)
    jf, jinl, _ = jmm.estimate(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                               JWF.identity(SOLVE_MESH), SOLVE_SIZE, jcfg.MeshMotionSettings(**kw))
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
            TWF.identity(SOLVE_MESH, device="cpu"), SOLVE_SIZE, tcfg.MeshMotionSettings(**kw))
    field, inl, res = distributed_solve.estimate_sharded(*args, _tiles(n_dev))
    solo_field, solo_inl, solo_res = tmm.estimate(*args)
    assert inl.shape == (n_feats,)
    assert np.abs((field.offsets.numpy() - np.asarray(jf.offsets)) * scale).max() <= 1e-3
    assert np.abs((field.offsets - solo_field.offsets).numpy() * scale).max() <= 1e-4
    assert torch.equal(inl, solo_inl)
    assert abs(float(res) - float(solo_res)) <= 1e-5
    assert (inl.numpy() == np.asarray(jinl)).mean() >= 0.99


# ------------------------------------------------------------ multihost


def test_multihost_single_process_matches_jax(monkeypatch):
    """initialize() is a no-op for one process; the global mesh, its local
    streams and its rows as in the JAX package's single-process run."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    multihost.initialize(coordinator_address="localhost:1234", num_processes=1)
    assert not torch.distributed.is_initialized()
    mesh = multihost.make_global_mesh(4, 2, local_devices=_cpus(8))
    jmesh = jmultihost.make_global_mesh(4, 2)
    assert mesh.devices.shape == jmesh.devices.shape
    assert multihost.local_stream_indices(mesh) == jmultihost.local_stream_indices(jmesh) == [0, 1, 2, 3]


def test_multihost_ranks_of_a_two_process_mesh():
    """Rank-major rows: each of two processes with four devices owns two
    stream rows; a row split across processes raises."""
    mesh = multihost.make_global_mesh(4, 2, local_devices=_cpus(4), num_processes=2)
    assert multihost.local_stream_indices(mesh, rank=0) == [0, 1]
    assert multihost.local_stream_indices(mesh, rank=1) == [2, 3]
    odd = multihost.make_global_mesh(2, 3, local_devices=_cpus(4), num_processes=2)
    with pytest.raises(ValueError, match="spans processes"):
        multihost.local_stream_indices(odd, rank=0)


def test_multihost_step_and_fetch():
    """Local frames placed W-striped on the rows, stepped, fetched back per
    stream: equal to the meshless tick; one process running rank 1's part
    of a two-process mesh steps streams 2 and 3 alone."""
    n_streams, n_frames = 4, 3
    clip = _clip(np.random.default_rng(5), n_streams, n_frames)
    filt = dryrun.tiny_flagship()
    spec = lt.FrameSpec(*SIZE, 1, GRAY)

    def frames(t, streams):
        k = len(streams)
        return lt.Frame(pixels=clip[streams, t], timestamp=torch.full((k,), t / 30.0),
                        valid=torch.ones(k, dtype=torch.bool), format=GRAY)

    mh = multihost.MultiHostStreamFilter(filt, multihost.make_global_mesh(4, 2, local_devices=_cpus(8)))
    assert mh.local_streams() == [0, 1, 2, 3]
    ref = par.MultiStreamFilter(filt, n_streams)
    states, ref_states = mh.init(spec, seed=1), ref.init(spec, device="cpu", seed=1)
    for t in range(n_frames):
        placed = mh.put_frames(frames(t, [0, 1, 2, 3]))
        assert isinstance(placed[0].tree.pixels, par.Stripes)
        states, out = mh.step(states, placed)
        ref_states, ref_out = ref.step(ref_states, frames(t, [0, 1, 2, 3]))
    outs = mh.fetch(out)
    assert len(outs) == n_streams and outs[0].shape == (1, *SIZE)
    np.testing.assert_array_equal(np.stack(outs), ref_out.pixels.numpy())

    two = multihost.make_global_mesh(4, 2, local_devices=_cpus(4), num_processes=2)
    r1 = multihost.MultiHostStreamFilter(filt, two, rank=1)
    solo = par.MultiStreamFilter(filt, 2)
    st, solo_st = r1.init(spec, seed=1), solo.init(spec, device="cpu", seed=1)
    for t in range(n_frames):
        st, out = r1.step(st, r1.put_frames(frames(t, [2, 3])))
        solo_st, solo_out = solo.step(solo_st, frames(t, [2, 3]))
    np.testing.assert_array_equal(np.stack(r1.fetch(out)), solo_out.pixels.numpy())
    with pytest.raises(ValueError, match="expected 2 local streams"):
        r1.put_frames(frames(0, [0, 1, 2]))


# ------------------------------------------------------------ entry points


def test_dryrun_multichip_small():
    """The four paths of the dry run on 8 repeated CPU devices, the chain
    and the halo remap at 64x512 (a 4x2 flagship mesh, the solve over 8
    devices, a 1x8 tile mesh); its remap equals the unsharded EASU warp
    within 1e-5."""
    rep = dryrun.dryrun_multichip(8, _cpus(8), uhd=(64, 512))
    assert rep["mesh"].shape == {"stream": 4, "tile": 2}
    assert torch.isfinite(rep["out"].pixels).all() and torch.isfinite(rep["field"].offsets).all()
    img, smap, _ = rep["remap_in"]
    want = tremap.remap(img, smap, fill=0.0, filter_mode="easu", fmt=GRAY)
    torch.testing.assert_close(rep["remap_out"], want, atol=1e-5, rtol=0)


@pytest.mark.slow
def test_run_multiproc_torch_two_workers():
    """Two processes joined through torch.distributed (gloo, a file
    rendezvous), each stepping its own streams of a (4, 2) global mesh,
    bit-equal to one process running both ranks' parts."""
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "run_multiproc_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "MULTIPROC OK" in proc.stdout
