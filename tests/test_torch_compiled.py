"""The compiled step (utils/compiled.jit_step) and the paths that replay it.

On the CPU a compiled step is the step itself (the tests' path), so here:

* `MultiStreamFilter.jit_step()` of the port, meshless and over an (S, 1)
  mesh of CPU devices, against the JAX package's
  `MultiStreamFilter.jit_step()` over a few ticks of the dry run's tiny
  flagship at 96x128 gray;
* what makes a new graph (`signature`), the donation copy of the new state
  into the static one (`donate`) and the generators found in a state;
* `process_clip`, `process_clip_sharded`, `stream()` and `stream_multi()`,
  their step compiled, against the op-by-op frame loop.

The `cuda` tests need a card and skip without one: a graph replay
bit-equal to the op-by-op step (the flagship at 1080p, solo and over an
8-stream tick), the generator advancing across replays as it does op by
op, a synchronizing step raising at capture, a new shape recapturing, the
buffer rules, and new compiled steps leaving the reserved memory flat.
JAX is imported inside the one test that needs it, so on a machine
without JAX (the card's):

    python -m pytest --noconftest -m cuda tests/test_torch_compiled.py
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import livevisionkit_tpu_torch as lt
from livevisionkit_tpu_torch.parallel import dryrun
from livevisionkit_tpu_torch.parallel import streams as par
from livevisionkit_tpu_torch.runtime import multistream, offline
from livevisionkit_tpu_torch.runtime import stream as tstream
from livevisionkit_tpu_torch.utils import compiled
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass

GRAY, YUV = lt.PixelFormat.GRAY, lt.PixelFormat.YUV
SIZE = (96, 128)
S = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _texture(rng, h, w):
    """A smooth random texture in [0, 1] (box-blurred noise plus blocks)."""
    t = rng.uniform(size=(h, w)).astype(np.float32)
    for axis in (0, 1):
        c = np.cumsum(np.pad(t, [(3, 3) if a == axis else (0, 0) for a in (0, 1)], mode="edge"),
                      axis=axis)
        t = ((np.take(c, range(6, c.shape[axis]), axis=axis)
              - np.take(c, range(0, c.shape[axis] - 6), axis=axis)) / 6.0)
    for _ in range(12):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        t[y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] = rng.uniform()
    return t


def _clip(seed, n, size=SIZE):
    """(n, h, w) f32 crops of a texture along a shaky integer path."""
    rng = np.random.default_rng(seed)
    h, w = size
    tex = _texture(rng, h + 48, w + 48)
    pos = np.cumsum(rng.integers(-3, 4, size=(n, 2)), axis=0) + 24
    pos = np.clip(pos, 0, 47)
    return np.stack([tex[y:y + h, x:x + w] for y, x in pos])


def _frame(px, t, dev, fmt=GRAY):
    """A frame (or a stacked batch) at time t/30, built on `dev`."""
    lead = px.shape[:-3]
    return lt.Frame(pixels=px, timestamp=torch.full(lead, t / 30.0, device=dev),
                    valid=torch.ones(lead, dtype=torch.bool, device=dev), format=fmt)


# ------------------------------------------------------------ JAX parity


@pytest.mark.parametrize("mesh", ["none", "S x 1", "multihost"])
def test_multistream_jit_step_matches_jax(mesh):
    """The port's `MultiStreamFilter.jit_step()` (meshless and over an
    (S, 1) mesh) and `MultiHostStreamFilter.jit_step()` against the JAX
    package's over 8 ticks of 4 gray 96x128 streams through the dry run's
    tiny flagship: valid flags and timestamps equal, correction offsets
    within 2e-3 normalised units (the bound of the step parity tests,
    tests/test_torch_multistream.py and tests/test_torch_stabilization.py:
    the packages draw different RANSAC samples)."""
    import jax
    import jax.numpy as jnp

    import livevisionkit_tpu as lj
    from livevisionkit_tpu.parallel import multihost as jmultihost
    from livevisionkit_tpu.parallel import streams as jstreams
    from livevisionkit_tpu_torch.parallel import multihost

    n = 8
    clips = np.stack([_clip(10 + s, n) for s in range(S)])[:, :, None]  # (S, n, 1, H, W)
    fj = lj.StabilizationFilter(settings=lj.StabilizationFilterSettings(
        tracker=lj.FrameTrackerSettings(
            detection_size=(48, 64), detector=lj.FeatureDetectorSettings(grid_shape=(4, 4)),
            min_motion_samples=6, motion=lj.MotionEstimationSettings(hypotheses=32)),
        smoother=lj.PathSmootherSettings(predictive_samples=2)))
    spec_j, spec_t = lj.FrameSpec(*SIZE, 1, lj.PixelFormat.GRAY), lt.FrameSpec(*SIZE, 1, GRAY)
    if mesh == "multihost":
        mj = jmultihost.MultiHostStreamFilter(fj, jmultihost.make_global_mesh(S, 1))
        mt = multihost.MultiHostStreamFilter(
            dryrun.tiny_flagship(), multihost.make_global_mesh(S, 1, local_devices=["cpu"] * S))
        sj, st = mj.init(spec_j), mt.init(spec_t, seed=0)
        put_j, put_t = mj.put_frames, mt.put_frames
    else:
        mj = jstreams.MultiStreamFilter(fj, S, jstreams.make_mesh(S, 1))
        tmesh = None if mesh == "none" else par.make_mesh(S, 1, ["cpu"] * S)
        mt = par.MultiStreamFilter(dryrun.tiny_flagship(), S, tmesh)
        sj, st = mj.init(spec_j), mt.init(spec_t, device="cpu")
        put_j, put_t = (lambda fr: mj._shard(fr, tile_w=False)), (lambda fr: fr)
    step_j, step_t = mj.jit_step(), mt.jit_step()
    for t in range(n):
        px = clips[:, t]
        fr = jax.vmap(lambda p: lj.Frame.create(p, timestamp=t / 30.0, fmt=lj.PixelFormat.GRAY))(
            jnp.asarray(px))
        sj, oj = step_j(sj, put_j(fr))
        st, ot = step_t(st, put_t(_frame(torch.from_numpy(px), t, "cpu")))
        st_u, ot = (st, ot) if mesh == "none" else (par.unshard(st, "cpu"), par.unshard(ot, "cpu"))
        valid = np.asarray(oj.valid)
        assert (ot.valid.numpy() == valid).all(), t
        assert (ot.timestamp.numpy()[valid] == np.asarray(oj.timestamp)[valid]).all(), t
        diff = np.abs(st_u.correction.offsets.numpy() - np.asarray(sj.correction.offsets)).max()
        assert diff <= 2e-3, (t, diff)
    assert valid.all()


# ------------------------------------------------------------ the buffer rules


def test_jit_step_on_the_cpu_is_the_step():
    """On CPU tensors the compiled step calls the step: same objects back,
    no graph."""
    seen = []

    def fn(state, x):
        seen.append(x)
        return state + x, state * 2

    step = compiled.jit_step(fn)
    st, out = step(torch.ones(3), torch.full((3,), 2.0))
    assert torch.equal(st, torch.full((3,), 3.0)) and torch.equal(out, torch.full((3,), 2.0))
    assert len(seen) == 1 and step.n_graphs == 0
    assert step.static_inputs(st, seen[0]) is None


def _signature(state, *inputs):
    return compiled.signature(*pytree.tree_flatten((state, inputs)))


def test_signature_names_what_makes_a_new_graph():
    """Equal for the same shapes and statics; new for a new shape, dtype,
    pixel format, Python drain flag or state generator."""
    filt = dryrun.tiny_flagship()
    state = filt.init(lt.FrameSpec(*SIZE, 1, GRAY), device="cpu")
    frame = _frame(torch.zeros((1, *SIZE)), 0, "cpu")
    base = _signature(state, frame, False)
    assert base == _signature(state, _frame(torch.ones((1, *SIZE)), 3, "cpu"), False)
    others = [
        _signature(state, _frame(torch.zeros((1, 96, 64)), 0, "cpu"), False),
        _signature(state, _frame(torch.zeros((1, *SIZE), dtype=torch.float64), 0, "cpu"), False),
        _signature(state, frame.replace(format=YUV), False),
        _signature(state, frame, True),
        _signature(filt.init(lt.FrameSpec(*SIZE, 1, GRAY), device="cpu"), frame, False),
    ]
    assert all(o != base for o in others)
    assert len(set(others)) == len(others)


def test_generators_of_a_state():
    """The RANSAC generator rides in a static field; it is found once."""
    filt = lt.CompositeFilter((dryrun.tiny_flagship(), dryrun.tiny_flagship()))
    state = filt.init(lt.FrameSpec(*SIZE, 1, GRAY), device="cpu")
    leaves, spec = pytree.tree_flatten(((state, state[0]), ()))
    gens = compiled.generators(leaves, spec)
    assert len(gens) == 2
    assert gens[0] is state[0].tracker.generator or gens[1] is state[0].tracker.generator
    assert any(g is state[1].tracker.generator for g in gens)


def test_donate_copies_the_new_state_into_the_buffers():
    """A leaf updated in place needs no copy; a permutation of the state's
    own tensors lands right; a new structure or shape raises."""
    a, b, c = torch.arange(3.0), torch.arange(3.0) + 10, torch.zeros(2)
    buffers, spec = pytree.tree_flatten({"a": a, "b": b, "c": c})
    c.add_(5.0)
    compiled.donate({"a": b, "b": a, "c": c}, buffers, spec)  # swap a and b
    assert torch.equal(a, torch.arange(3.0) + 10) and torch.equal(b, torch.arange(3.0))
    assert torch.equal(c, torch.full((2,), 5.0))
    compiled.donate({"a": b[[1, 0, 2]], "b": torch.ones(3), "c": c}, buffers, spec)
    assert torch.equal(a, torch.tensor([1.0, 0.0, 2.0])) and torch.equal(b, torch.ones(3))
    with pytest.raises(ValueError, match="structure"):
        compiled.donate({"a": a, "b": b}, buffers, spec)
    with pytest.raises(ValueError, match="state tensor"):
        compiled.donate({"a": a, "b": b, "c": torch.zeros(3)}, buffers, spec)


# ------------------------------------------------------------ the paths


def test_process_clip_compiled_equals_the_frame_loop():
    """`process_clip` (the frame index a device counter, one step a frame)
    bit-equal to a loop of the filter's step."""
    filt = dryrun.tiny_flagship()
    clip = torch.from_numpy(_clip(3, 10))[:, None]
    _, out = offline.process_clip(filt, clip, GRAY, device="cpu")
    state = filt.init(lt.FrameSpec(*SIZE, 1, GRAY), device="cpu")
    for t in range(clip.shape[0]):
        state, ref = filt.step(state, _frame(clip[t], t, "cpu"))
        assert torch.equal(out.pixels[t], ref.pixels) and torch.equal(out.valid[t], ref.valid)
        assert torch.equal(out.timestamp[t], ref.timestamp)
    assert out.valid.tolist() == [t >= filt.delay for t in range(clip.shape[0])]


def test_process_clip_sharded_compiled_equals_op_by_op():
    filt = dryrun.tiny_flagship()
    clip = torch.from_numpy(_clip(4, 12))[:, None]
    mesh = par.Mesh(["cpu"] * 2, ("time",))
    got = offline.process_clip_sharded(filt, clip, GRAY, mesh, overlap=4)
    ref = offline.process_clip_sharded(filt, clip, GRAY, mesh, overlap=4, jit=False)
    for a, b in zip((got.pixels, got.timestamp, got.valid), (ref.pixels, ref.timestamp, ref.valid)):
        assert torch.equal(a, b)


def test_uploader_writes_into_given_buffers():
    """`send(out)` copies the filled slot into the caller's tensors (a
    compiled step's static inputs) and hands those back."""
    from livevisionkit_tpu_torch.runtime.transfer import Uploader

    up = Uploader([((2, 3), torch.uint8), ((1,), torch.float32)], "cpu", 2)
    dst = [torch.zeros((2, 3), dtype=torch.uint8), torch.zeros(1)]
    for k in range(3):
        raw, meta = up.host()
        raw[...] = k + 1
        meta[0] = k / 2
        got = up.send(dst)
        assert got[0] is dst[0] and got[1] is dst[1]
        assert torch.equal(dst[0], torch.full((2, 3), k + 1, dtype=torch.uint8))
        assert float(dst[1]) == k / 2


def _bgr(seed, n):
    """u8 (H, W, 3) BGR frames with distinct channels."""
    g = _clip(seed, n)
    return [np.clip(np.stack([f, 0.2 + 0.6 * f, np.roll(f, 3, 1)], -1) * 255.0 + 0.5, 0, 255)
            .astype(np.uint8) for f in g]


def _ingest_loop(filt, frames):
    """The op-by-op reference of the drivers: BGR u8 -> YUV, step, -> BGR."""
    state = filt.init(lt.FrameSpec(*SIZE, 3, YUV), device="cpu")
    outs = []
    for t, raw in enumerate(frames):
        fr = lt.Frame(pixels=tstream._ingest(torch.from_numpy(raw)),
                      timestamp=torch.tensor(np.float32(t / 30.0)),
                      valid=torch.ones((), dtype=torch.bool), format=lt.PixelFormat.BGR)
        state, out = filt.step(state, fr.reformat(YUV))
        out = out.reformat(lt.PixelFormat.BGR)
        if bool(out.valid):
            outs.append((out.pixels.numpy(), float(out.timestamp)))
    return outs


def test_stream_compiled_equals_the_frame_loop():
    """`stream()` with its step compiled (the default) and with jit off,
    both bit-equal to the op-by-op loop of ingest, step and conversion."""
    filt = dryrun.tiny_flagship()
    frames = _bgr(5, 9)
    want = _ingest_loop(filt, frames)
    for jit in (True, False):
        got = []
        tstream.stream(filt, iter([(f, t / 30.0) for t, f in enumerate(frames)]),
                       lambda px, ts: got.append((px.copy(), ts)), device="cpu", jit=jit)
        assert len(got) == len(want) == len(frames) - filt.delay
        for (px, ts), (wpx, wts) in zip(got, want):
            assert ts == wts and np.array_equal(px, wpx)


def test_stream_multi_compiled_equals_op_by_op():
    """`stream_multi()` with its tick compiled against jit off, per stream
    and frame bit-equal, the drain tail included."""
    filt = dryrun.tiny_flagship()
    clips = [_bgr(6 + s, 6) for s in range(2)]
    runs = {}
    for jit in (True, False):
        got = [[], []]
        stats = multistream.stream_multi(
            filt, [iter([(f, t / 30.0) for t, f in enumerate(c)]) for c in clips],
            lambda i, px, ts: got[i].append((px.copy(), ts)), device="cpu", jit=jit)
        assert stats.frames_out == 12
        runs[jit] = got
    for i in range(2):
        assert [ts for _, ts in runs[True][i]] == [ts for _, ts in runs[False][i]]
        for (a, _), (b, _) in zip(runs[True][i], runs[False][i]):
            assert np.array_equal(a, b)


# ------------------------------------------------------------ on the card


def _clone_tree(tree):
    return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _assert_trees_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_graph_replay_bit_equal_to_eager_solo_1080p(cuda):
    """The flagship at 1080p YUV, 14 frames: every output and correction of
    the replayed graph bit-equal to the op-by-op step from the same seed;
    the returned state is the static state."""
    filt = lt.flagship_filter()
    spec = lt.FrameSpec(1080, 1920, 3, YUV)
    clip = torch.from_numpy(_clip(7, 14, (1080, 1920))).to(cuda)
    eager, state = filt.init(spec, device=cuda), filt.init(spec, device=cuda)
    step = compiled.jit_step(filt.step)
    first = None
    for t in range(clip.shape[0]):
        px = torch.stack([clip[t], torch.full_like(clip[t], 0.5), torch.full_like(clip[t], 0.5)])
        eager, want = filt.step(eager, _frame(px, t, cuda, YUV))
        state, out = step(state, _frame(px, t, cuda, YUV))
        first = first or state
        assert state is first
        _assert_trees_equal(out, want)
        assert torch.equal(state.correction.offsets, eager.correction.offsets)
    assert step.n_graphs == 1
    assert bool(out.valid)


@pytest.mark.cuda
def test_graph_replay_bit_equal_to_eager_8_stream_tick(cuda):
    """The flagship over an 8-stream 1080p tick, 12 ticks: outputs and
    corrections bit-equal to `MultiStreamFilter.step`."""
    multi = par.MultiStreamFilter(lt.flagship_filter(), 8)
    spec = lt.FrameSpec(1080, 1920, 1, GRAY)
    clips = torch.from_numpy(np.stack([_clip(20 + s, 12, (1080, 1920)) for s in range(8)])).to(cuda)
    eager, state = multi.init(spec, device=cuda), multi.init(spec, device=cuda)
    step = multi.jit_step()
    for t in range(clips.shape[1]):
        px = clips[:, t, None].contiguous()
        eager, want = multi.step(eager, _frame(px, t, cuda))
        state, out = step(state, _frame(px, t, cuda))
        _assert_trees_equal(out, want)
        assert torch.equal(state.correction.offsets, eager.correction.offsets)
    assert bool(out.valid.all())


@pytree_dataclass(static=("gen",))
@dataclass(frozen=True)
class _Draws:
    acc: torch.Tensor
    gen: torch.Generator


@pytest.mark.cuda
def test_graph_generator_advances_as_eager(cuda):
    """A step drawing from a state's generator: replays draw what the
    op-by-op step draws from the same seed, call after call, and leave the
    generator where it leaves it."""

    def fn(st, x):
        u = torch.rand((4,), generator=st.gen, device=x.device)
        return _Draws(acc=st.acc + u, gen=st.gen), u * x

    def fresh():
        g = torch.Generator(device=cuda)
        g.manual_seed(5)
        return _Draws(acc=torch.zeros(4, device=cuda), gen=g)

    eager, state = fresh(), fresh()
    step = compiled.jit_step(fn)
    for k in range(5):
        x = torch.full((4,), float(k + 1), device=cuda)
        eager, want = fn(eager, x)
        state, out = step(state, x)
        assert torch.equal(out, want) and torch.equal(state.acc, eager.acc), k
    assert torch.equal(state.gen.get_state(), eager.gen.get_state())


def _reads_back(st, x):
    if bool((x > 0).all()):  # a device value read on the host: a sync
        st = st + x
    return st, x


def _copies_from_the_host(st, x):
    # A copy from pageable host memory: not a sync, but not capturable.
    return st + torch.ones(3).to(x.device, non_blocking=True), x


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [_reads_back, _copies_from_the_host])
def test_synchronizing_step_raises_at_capture(cuda, fn):
    """A step that reads back or copies from the host raises at its first
    call (the warm-up's sync check or the capture), makes no graph, and
    leaves the card working."""
    step = compiled.jit_step(fn)
    with pytest.raises(RuntimeError):
        step(torch.zeros(3, device=cuda), torch.ones(3, device=cuda))
    assert step.n_graphs == 0
    ok = compiled.jit_step(lambda st, x: (st + x, x * 2))
    st, out = ok(torch.zeros(3, device=cuda), torch.ones(3, device=cuda))
    assert torch.equal(st.cpu(), torch.ones(3)) and torch.equal(out.cpu(), torch.full((3,), 2.0))


@pytest.mark.cuda
def test_graph_buffer_rules_and_recapture(cuda):
    """The state returned is the static state, kept in place across calls;
    a second call with new inputs equals the op-by-op step; its outputs are
    overwritten by the next call; the static inputs are taken without a
    copy; another state is copied in; a new shape makes a second graph."""

    def fn(st, x):
        return st * 0.5 + x, (st * x).sum(dim=-1)

    step = compiled.jit_step(fn)
    x1, x2 = torch.arange(4.0, device=cuda), torch.full((4,), 3.0, device=cuda)
    st, out = step(torch.ones(4, device=cuda), x1)
    st_ref, out_ref = fn(torch.ones(4, device=cuda), x1)
    assert torch.equal(st, st_ref) and torch.equal(out, out_ref)
    kept = out.clone()
    st2, out2 = step(st, x2)
    st_ref, out_ref = fn(st_ref, x2)
    assert st2 is st and out2 is out and torch.equal(st2, st_ref) and torch.equal(out2, out_ref)
    assert not torch.equal(out, kept)  # overwritten by the second call
    (x_static,) = step.static_inputs(st2, x2)
    x_static.fill_(1.0)
    st3, _ = step(st2, x_static)
    st_ref, _ = fn(st_ref, torch.ones(4, device=cuda))
    assert torch.equal(st3, st_ref)
    st4, _ = step(torch.zeros(4, device=cuda), x1)  # another state, copied in
    assert st4 is st and torch.equal(st4, x1)
    assert step.n_graphs == 1
    big, big_out = step(torch.ones(8, device=cuda), torch.ones(8, device=cuda))
    assert step.n_graphs == 2 and torch.equal(big.cpu(), torch.full((8,), 1.5))
    assert torch.equal(big_out.cpu(), torch.tensor(8.0))
    assert torch.equal(st4, x1)  # the first graph's state untouched


@pytest.mark.cuda
def test_new_compiled_steps_do_not_grow_reserved_memory(cuda):
    """Compiled steps made one after another (a `stream_multi` session
    each) capture on one stream per device: cuBLAS's workspace for that
    stream is made once, and the reserved memory stays flat."""
    x = torch.randn(256, 256, device=cuda)

    def step(state, x):
        return state + 1, (x @ x).sum()

    reserved = []
    for _ in range(5):
        fn = compiled.jit_step(step)
        fn(torch.zeros((), device=cuda), x)
        assert fn.n_graphs == 1
        del fn
        torch.cuda.synchronize(cuda)
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert len(set(reserved[1:])) == 1, reserved  # flat after the first capture

