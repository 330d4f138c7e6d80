"""Port parity: RANSAC + IRLS with the JAX draw's minimal sets injected, and
the RANSAC kernel (K7, csrc/ransac.cu) against its plain version.

The `cuda` tests need a card and skip without one (a CUDA kernel has no CPU
mode).  The JAX reference is imported only where it is installed, so on a
machine without JAX the card's tests run without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_ransac.py
"""

import functools

import numpy as np
import pytest
import torch

from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.models.homography import dlt4
from livevisionkit_tpu_torch.ops.cuda_kernels import ransac as ransac_kernel
from livevisionkit_tpu_torch.vision import ransac as tr

try:  # the JAX reference: the CPU parity tests' only
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.config import MotionEstimationSettings
    from livevisionkit_tpu.models.homography import Homography as JH
    from livevisionkit_tpu.vision import ransac as jr
except ImportError:
    jax = None


@functools.cache
def _jax_estimate():
    """One compiled JAX estimate for every case (the model choice is traced)."""
    return jax.jit(lambda src, dst, valid, key, use_h: jr.estimate(
        src, dst, valid, key, MotionEstimationSettings(hypotheses=32), use_homography=use_h,
        min_samples=8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RANSAC kernel has no CPU mode")
    return torch.device("cuda", 0)


def _problem(seed, n=60, n_valid=48, outliers=8):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 64, size=(n, 2)).astype(np.float32)
    h = np.array([[1.01, 0.02, 1.5], [-0.015, 0.99, -2.0], [1e-4, -2e-4, 1.0]], np.float32)
    ph = np.concatenate([src, np.ones((n, 1), np.float32)], 1) @ h.T
    dst = (ph[:, :2] / ph[:, 2:3] + rng.normal(0, 0.3, size=(n, 2))).astype(np.float32)
    dst[:outliers] += rng.uniform(10, 20, size=(outliers, 2)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    return src, dst, valid


@pytest.mark.parametrize(
    "case,use_h,n_valid",
    [("homography", True, 48), ("similarity", False, 48), ("too_few", True, 5)],
)
def test_estimate_matches_jax_with_injected_indices(case, use_h, n_valid):
    """(e) The same (K, 4) minimal sets (drawn by the very call at
    ransac.py:206-207): the final model maps the frame corners within
    1e-2 px, the inlier masks and `ok` are equal."""
    src, dst, valid = _problem(11, n_valid=n_valid)
    settings = MotionEstimationSettings(hypotheses=32)
    key = jax.random.key(3)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits, shape=(settings.hypotheses, 4)))
    ej = _jax_estimate()(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                         jnp.asarray(use_h))
    et = tr.estimate(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), None,
                     tcfg.MotionEstimationSettings(hypotheses=32), use_homography=use_h,
                     min_samples=8, indices=torch.from_numpy(idx))
    corners = np.array([[0, 0], [63, 0], [0, 47], [63, 47]], np.float32)
    cj = np.asarray(JH(m=ej.homography.m).transform(jnp.asarray(corners)))
    ct = et.homography.transform(torch.from_numpy(corners)).numpy()
    assert np.abs(ct - cj).max() <= 1e-2
    np.testing.assert_array_equal(et.inliers.numpy(), np.asarray(ej.inliers))
    assert bool(et.ok) == bool(ej.ok)
    assert bool(et.ok) == (case != "too_few")


def test_sampler_draws_only_valid_indices():
    """The port's own sampler: uniform over valid features, on the device."""
    valid = torch.zeros(60, dtype=torch.bool)
    valid[torch.tensor([3, 17, 18, 40, 59])] = True
    gen = torch.Generator().manual_seed(0)
    idx = tr.sample_indices(valid, 256, gen)
    assert idx.shape == (256, 4)
    assert bool(valid[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=60)[valid]
    assert int(counts.min()) > 150  # 1024 draws over 5 features: ~205 each


# ---------------------------------------------------------------------------
# The kernel's op (lvk::ransac_estimate) and its plain version.

N, K = 510, 256  # the benchmark's shapes: a 17 x 30 feature grid, 256 hypotheses
SIZE = (272, 480)  # the detection frame (rows, columns)
CORNERS = torch.tensor([[0.0, 0.0], [479.0, 0.0], [0.0, 271.0], [479.0, 271.0]])


def _frame_problem(seed, n=N, k=K, outliers=0.2, valid_share=0.85):
    """A detection-frame problem: n correspondences under a near-rigid
    homography with 0.3 px noise, a share of gross outliers, a share of
    invalid features, and k minimal sets drawn from the valid ones.
    Returns (src, dst, valid, indices) CPU tensors."""
    rng = np.random.default_rng(seed)
    src = rng.uniform([0, 0], [SIZE[1], SIZE[0]], size=(n, 2)).astype(np.float32)
    th, s = rng.uniform(-0.02, 0.02), 1.0 + rng.uniform(-0.02, 0.02)
    h = np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-8, 8)],
                  [s * np.sin(th), s * np.cos(th), rng.uniform(-8, 8)],
                  [rng.uniform(-2e-5, 2e-5), rng.uniform(-2e-5, 2e-5), 1.0]])
    ph = np.concatenate([src, np.ones((n, 1))], 1) @ h.T
    dst = (ph[:, :2] / ph[:, 2:3] + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    out = rng.uniform(size=n) < outliers
    dst[out] += rng.uniform(-40, 40, (int(out.sum()), 2)).astype(np.float32)
    valid = rng.uniform(size=n) < valid_share
    vi = np.flatnonzero(valid)
    idx = vi[rng.integers(0, len(vi), size=(k, 4))] if len(vi) else np.zeros((k, 4), np.int64)
    return (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
            torch.from_numpy(idx.astype(np.int64)))


def _corner_map(m: torch.Tensor) -> torch.Tensor:
    p = torch.cat([CORNERS.double(), torch.ones(4, 1, dtype=torch.float64)], 1) @ m.double().cpu().T
    return p[:, :2] / p[:, 2:]


def _op_t(src, dst, valid, idx, use_h, tau, rounds=4, min_samples=8):
    return torch.ops.lvk.ransac_estimate(src, dst, valid, idx, use_h, tau, rounds, min_samples)


def _op(src, dst, valid, idx, use_h, tau, rounds=4, min_samples=8):
    """The op with `use_h` a bool, made a tensor on the points' device."""
    return _op_t(src, dst, valid, idx, torch.tensor(use_h, device=src.device), tau, rounds,
                 min_samples)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("use_h", [True, False])
def test_op_on_cpu_is_the_plain_version(use_h):
    """The custom op on CPU tensors runs estimate_plain: bit for bit the
    same results, and the kernel is not launched."""
    src, dst, valid, idx = _frame_problem(5, n=120, k=64)
    before = ransac_kernel.ransac_estimate.launches
    got = _op(src, dst, valid, idx, use_h, 3.0)
    want = tr.estimate_plain(src, dst, valid, idx, torch.tensor(use_h), 3.0, 4, 8)
    assert ransac_kernel.ransac_estimate.launches == before
    assert _bit_equal(got, want)
    assert got[0].shape == (3, 3) and got[1].shape == (120,) and got[4].shape == (2,)
    assert bool(got[3]) and float(got[2]) > 0.5


def test_public_estimate_goes_through_the_op():
    """`estimate` with injected indices equals the op's plain version."""
    src, dst, valid, idx = _frame_problem(6, n=120, k=64)
    settings = tcfg.MotionEstimationSettings(hypotheses=64, inlier_threshold_px=10.0)
    est = tr.estimate(src, dst, valid, None, settings, use_homography=True, indices=idx)
    m, inl, stab, ok, _ = tr.estimate_plain(src, dst, valid, idx, torch.tensor(True), 10.0, 4, 8)
    assert _bit_equal((est.homography.m, est.inliers, est.stability, est.ok), (m, inl, stab, ok))


def test_vmap_over_the_op_equals_solo_calls():
    """torch.func.vmap over the op (the batched op's plain path on the
    CPU, as MultiStreamFilter's tick runs it) against a loop of solo calls:
    equal winners, inliers and `ok`, models within 1e-4 px at the corners
    (the batched reductions may sum in another order)."""
    probs = [_frame_problem(20 + s, n=120, k=64) for s in range(3)]
    src, dst, valid, idx = (torch.stack(t) for t in zip(*probs))
    use_h = torch.tensor([True, False, True])
    got = torch.func.vmap(lambda a, b, v, i, u: _op_t(a, b, v, i, u, 3.0))(src, dst, valid, idx,
                                                                           use_h)
    for s in range(3):
        want = _op_t(src[s], dst[s], valid[s], idx[s], use_h[s], 3.0)
        assert (_corner_map(got[0][s]) - _corner_map(want[0])).abs().max() <= 1e-4
        for g, w in zip(got[1:], want[1:]):
            if g.dtype == torch.float32:
                assert abs(float(g[s]) - float(w)) <= 1e-6
            else:
                assert torch.equal(g[s], w)



def test_kernel_wrapper_rejects_what_it_does_not_take():
    """The wrapper raises on what the kernel does not take (checked before
    the device, so this runs without a card), and on CPU tensors: it never
    falls back to the plain version."""
    src, dst, valid, idx = _frame_problem(7, n=64, k=16)
    use_h = torch.tensor(True)

    def call(**kw):
        args = dict(src=src, dst=dst, valid=valid, indices=idx, use_h=use_h)
        args.update(kw)
        return ransac_kernel.ransac_estimate(**args, tau=3.0, rounds=4, min_samples=8)

    with pytest.raises(TypeError, match="src"):
        call(src=src.double())
    with pytest.raises(TypeError, match="indices"):
        call(indices=idx.int())
    with pytest.raises(ValueError, match="points"):
        big = torch.zeros((ransac_kernel._MAX_POINTS + 1, 2))
        call(src=big, dst=big, valid=torch.ones(big.shape[0], dtype=torch.bool))
    with pytest.raises(ValueError, match="hypotheses"):
        call(indices=torch.zeros((ransac_kernel._MAX_HYPOTHESES + 1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(K, 4\)"):
        call(indices=idx[:, :3].contiguous())
    with pytest.raises(ValueError, match="use_h"):
        call(use_h=torch.tensor([True]))
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="CUDA"):
        ransac_kernel.ransac_estimate(src[None], dst[None], valid[None], idx[None], use_h[None],
                                      3.0, 4, 8)


def _check_against_plain(got, want, what, best=True):
    """The kernel's results against the plain version's on the card: the
    corner map within 1e-3 px (the kernel sums in another order, and its
    scores divide by a reciprocal), inliers, `ok`, stability and (where
    `best`) the winners' indices equal."""
    m, inl, stab, ok, win = got
    pm, pinl, pstab, pok, pwin = want
    err = (_corner_map(m) - _corner_map(pm)).abs().max().item()
    assert err <= 1e-3, f"{what}: corners {err} px apart"
    assert torch.equal(inl, pinl), f"{what}: {int((inl != pinl).sum())} inliers differ"
    assert bool(ok) == bool(pok), what
    assert float(stab) == float(pstab), what
    if best:
        assert win.tolist() == pwin.tolist(), f"{what}: winners {win.tolist()} vs {pwin.tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [3.0, 10.0])
@pytest.mark.parametrize("use_h", [True, False])
def test_ransac_kernel_matches_plain(cuda, tau, use_h):
    """K7 against estimate_plain on the card at the benchmark's shapes (N =
    510, K = 256, 4 rounds), over 6 seeded problems with injected indices."""
    before = ransac_kernel.ransac_estimate.launches
    for seed in range(6):
        src, dst, valid, idx = (t.to(cuda) for t in _frame_problem(100 + seed))
        uh = torch.tensor(use_h, device=cuda)
        got = _op(src, dst, valid, idx, use_h, tau)
        want = tr.estimate_plain(src, dst, valid, idx, uh, tau, 4, 8)
        torch.cuda.synchronize()
        _check_against_plain(got, want, f"seed {seed}")
        assert bool(got[3])
    assert ransac_kernel.ransac_estimate.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 1024), (100, 37), (12, 1)])
def test_ransac_kernel_at_other_shapes(cuda, n, k):
    """The kernel's largest shapes (their shared memory takes the opt-in
    above 48 KB), a hypothesis count that leaves the cluster's blocks
    unequal shares, and one hypothesis (seven blocks with none)."""
    src, dst, valid, idx = (t.to(cuda) for t in _frame_problem(80 + k, n=n, k=k))
    for use_h in (True, False):
        got = _op(src, dst, valid, idx, use_h, 3.0)
        want = tr.estimate_plain(src, dst, valid, idx, torch.tensor(use_h, device=cuda), 3.0, 4, 8)
        torch.cuda.synchronize()
        _check_against_plain(got, want, f"N {n} K {k} use_h {use_h}")


@pytest.mark.cuda
def test_ransac_kernel_hypotheses_are_plain_bit_for_bit(cuda):
    """The kernel's DLT runs dlt4's arithmetic step for step: with
    refine_iterations = 0 and min_samples = 0 its result is the winner
    itself, bit-equal to the plain dlt4 of the winning quad."""
    src, dst, valid, idx = (t.to(cuda) for t in _frame_problem(31))
    m, _, _, _, win = _op(src, dst, valid, idx, True, 3.0, rounds=0, min_samples=0)
    q = idx[win[0]]
    want = dlt4(src[q][None], dst[q][None])[0]
    assert torch.equal(m.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("use_h", [True, False])
@pytest.mark.parametrize("case", ["too_few", "repeated", "collinear", "no_valid", "non_pd"])
def test_ransac_kernel_degenerate_inputs(cuda, case, use_h):
    """Degenerate inputs agree with plain: fewer than min_samples valid
    points; every quad one point repeated (every model non-finite, scores
    -inf, the identity fallback); half the quads on a line; no valid point;
    an all-zero IRLS weight (quads drawn from invalid points that follow
    another motion: the normal block is not positive definite and the
    previous model is kept, visible with min_samples = 0)."""
    src, dst, valid, idx = _frame_problem(40)
    min_samples, best = 8, True
    if case == "too_few":
        valid = torch.zeros_like(valid)
        valid[torch.tensor([3, 50, 97, 200, 404])] = True
        vi = torch.nonzero(valid)[:, 0]
        idx = vi[torch.randint(0, 5, (K, 4), generator=torch.Generator().manual_seed(0))]
        best = False  # quads of the same 5 points: models equal up to rounding, scores tie
    elif case == "repeated":
        idx = idx[:, :1].repeat(1, 4)
    elif case == "collinear":
        line = torch.arange(40)
        t = torch.linspace(10.0, 400.0, 40)
        src[line] = torch.stack([t, 0.4 * t + 20.0], 1)
        dst[line] = src[line] + torch.tensor([3.0, -2.0])
        valid[line] = True
        idx[: K // 2] = line[torch.randint(0, 40, (K // 2, 4),
                                           generator=torch.Generator().manual_seed(1))]
    elif case == "no_valid":
        valid = torch.zeros_like(valid)
    else:  # non_pd: every model the translation (1, 1), every valid point 60 px off it
        inv = torch.nonzero(~valid)[:, 0]
        dst = src + torch.where(valid[:, None], 61.0, 1.0)
        idx = inv[torch.randint(0, len(inv), (K, 4), generator=torch.Generator().manual_seed(2))]
        min_samples = 0
    src, dst, valid, idx = (t.to(cuda) for t in (src, dst, valid, idx))
    got = _op(src, dst, valid, idx, use_h, 3.0, min_samples=min_samples)
    want = tr.estimate_plain(src, dst, valid, idx, torch.tensor(use_h, device=cuda), 3.0, 4,
                             min_samples)
    torch.cuda.synchronize()
    _check_against_plain(got, want, case, best=best)
    if case in ("too_few", "repeated", "no_valid"):
        assert not bool(got[3]) and torch.equal(got[0], torch.eye(3, device=cuda))
    if case == "non_pd" and use_h:
        hyp0 = dlt4(src[idx[0]][None], dst[idx[0]][None])[0]
        assert bool(got[3]) and torch.equal(got[0], hyp0), "the first hypothesis is not kept"


@pytest.mark.cuda
def test_ransac_kernel_is_deterministic(cuda):
    """Two launches give bit-identical outputs (no atomics, a fixed order)."""
    src, dst, valid, idx = (t.to(cuda) for t in _frame_problem(50))
    for use_h in (True, False):
        a = _op(src, dst, valid, idx, use_h, 3.0)
        b = _op(src, dst, valid, idx, use_h, 3.0)
        assert _bit_equal(a, b)


@pytest.mark.cuda
def test_ransac_kernel_batched_equals_solo(cuda):
    """The batched op at S = 8 (one launch) equals eight solo launches bit
    for bit, also with `use_h` shared at stream stride 0; under
    torch.func.vmap the op launches once."""
    probs = [[t.to(cuda) for t in _frame_problem(60 + s)] for s in range(8)]
    src, dst, valid, idx = (torch.stack(t) for t in zip(*probs))
    use_h = torch.tensor([s % 3 != 0 for s in range(8)], device=cuda)
    before = ransac_kernel.ransac_estimate.launches
    got = torch.ops.lvk.ransac_estimate_batched(src, dst, valid, idx, use_h, 3.0, 4, 8)
    assert ransac_kernel.ransac_estimate.launches == before + 1
    for s in range(8):
        solo = _op_t(src[s], dst[s], valid[s], idx[s], use_h[s], 3.0)
        assert _bit_equal([g[s] for g in got], solo), f"stream {s}"
    shared = torch.ops.lvk.ransac_estimate_batched(
        src, dst, valid, idx, torch.tensor(True, device=cuda).expand(8), 3.0, 4, 8)
    for s in range(8):
        solo = _op_t(src[s], dst[s], valid[s], idx[s], torch.tensor(True, device=cuda), 3.0)
        assert _bit_equal([g[s] for g in shared], solo), f"stream {s} at stride 0"
    before = ransac_kernel.ransac_estimate.launches
    mapped = torch.func.vmap(lambda a, b, v, i, u: _op_t(a, b, v, i, u, 3.0))(src, dst, valid, idx,
                                                                              use_h)
    assert ransac_kernel.ransac_estimate.launches == before + 1
    assert _bit_equal(mapped, got)


@pytest.mark.cuda
def test_ransac_kernel_in_a_captured_graph(cuda):
    """`estimate` with the tracker's draw (sample_indices on a registered
    generator) captures into a CUDA graph: the capture launches K7 once
    and replays give the eager call's bits from the same seed."""
    src, dst, valid, _ = (t.to(cuda) for t in _frame_problem(70))
    settings = tcfg.MotionEstimationSettings()
    gen = torch.Generator(device=cuda)
    use_h = torch.tensor(True, device=cuda)  # before the capture: a host copy is not captured

    def run():
        e = tr.estimate(src, dst, valid, gen, settings, use_homography=use_h)
        return e.homography.m, e.inliers, e.stability, e.ok

    gen.manual_seed(9)
    eager = [t.clone() for t in run()]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    before = ransac_kernel.ransac_estimate.launches
    with torch.cuda.graph(graph):
        out = run()
    assert ransac_kernel.ransac_estimate.launches == before + 1
    gen.manual_seed(9)
    graph.replay()
    torch.cuda.synchronize()
    assert ransac_kernel.ransac_estimate.launches == before + 1
    assert _bit_equal(out, eager)
