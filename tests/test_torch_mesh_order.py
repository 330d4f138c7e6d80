"""The mesh solve's feature sums in a fixed order (vision/mesh_motion.py).

The feature operator A is a dense (N, nodes) matrix built once per solve
(`_operator`), its normal matrix A^T W A once per IRLS round (`_normal`):
every feature sum of the CG (the right-hand side A^T W d, each
iteration's A^T W A x, the temporal support) is a matrix product, where
an `index_add` would add with atomics on the card, in no fixed order.  On
the CPU: A against the gather `_sample`, A^T against `index_add` and the
JAX package's `segment_sum`, the adjoint identity, the normal matrix
against A^T (W (A x)), the temporal weight against JAX's, and the
products under `torch.func.vmap` against their per-stream calls.

The `cuda` tests need a card and skip without one: two solves on the same
card inputs bit-equal, and the mesh stabilizer's step replayed as a CUDA
graph bit-equal to the op-by-op step.  JAX is imported inside the tests
that need it, so on a machine without JAX (the card's):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_order.py
"""

import numpy as np
import pytest
import torch

import livevisionkit_tpu_torch as lt
from livevisionkit_tpu_torch import config as tcfg
from livevisionkit_tpu_torch.models import warp_field as twf
from livevisionkit_tpu_torch.presets import stabilization_preset
from livevisionkit_tpu_torch.utils import compiled
from livevisionkit_tpu_torch.vision import mesh_motion as tmm

SIZE, MESH = (96, 120), (9, 11)  # tests/test_torch_mesh.py's solve size
NODES = MESH[0] * MESH[1]


def _points(rng, n=300, size=SIZE):
    h, w = size
    return np.stack([rng.uniform(2, w - 3, n), rng.uniform(2, h - 3, n)], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(seed):
    """(idx, w4, A, residuals (N, 2), weights (N,), mesh x (2, Hm, Wm)) of
    random points."""
    rng = np.random.default_rng(seed)
    pts = _points(rng)
    idx, w4 = tmm._bilinear_weights(_t(pts), MESH, SIZE)
    res = _t(rng.normal(size=(len(pts), 2)).astype(np.float32))
    wf = _t(rng.uniform(size=len(pts)).astype(np.float32))
    x = _t(rng.normal(size=(2, *MESH)).astype(np.float32))
    return idx, w4, tmm._operator(idx, w4, NODES), res, wf, x


def test_operator_is_the_bilinear_sample():
    """Each row of A holds its feature's four weights at its four nodes
    and nothing else; A x equals the gather `_sample` to rounding."""
    idx, w4, a, _, _, x = _case(1)
    assert a.shape == (idx.shape[0], NODES) and a.dtype == torch.float32
    assert torch.equal((a != 0).sum(dim=1), (w4 != 0).sum(dim=1))
    assert torch.equal(torch.gather(a, 1, idx), w4)
    torch.testing.assert_close((x.reshape(2, -1) @ a.T).T, tmm._sample(x, idx, w4), rtol=0, atol=1e-6)


def test_scatter_equals_index_add_to_rounding():
    """A^T r against the atomic scatter it replaces, to f32 rounding of a
    sum of ~12 taps a node."""
    idx, w4, a, res, _, _ = _case(2)
    contrib = (res[:, :, None] * w4[:, None, :]).transpose(0, 1).reshape(2, -1)
    want = torch.zeros(2, NODES).index_add(1, idx.reshape(-1), contrib)
    torch.testing.assert_close(tmm._scatter(res, a), want, rtol=0, atol=1e-6)


def test_scatter_matches_jax_and_is_adjoint():
    """A^T r within 1e-5 of JAX's `_scatter` (segment_sum), the bound of
    tests/test_torch_mesh.py, and <A x, r> = <x, A^T r> to 1e-5 relative."""
    import jax.numpy as jnp

    from livevisionkit_tpu.vision import mesh_motion as jmm

    rng = np.random.default_rng(3)
    pts = _points(rng)
    x = rng.normal(size=(2, *MESH)).astype(np.float32)
    r = rng.normal(size=(len(pts), 2)).astype(np.float32)
    idx, w4 = tmm._bilinear_weights(_t(pts), MESH, SIZE)
    ij, wj = jmm._bilinear_weights(jnp.asarray(pts), MESH, SIZE)
    atr = tmm._scatter(_t(r), tmm._operator(idx, w4, NODES))
    np.testing.assert_allclose(atr.numpy(), np.asarray(jmm._scatter(jnp.asarray(r), ij, wj, NODES)),
                               rtol=0, atol=1e-5)
    ax = tmm._sample(_t(x), idx, w4)
    lhs = float((ax.double() * _t(r).double()).sum())
    rhs = float((_t(x).double().reshape(2, -1) * atr.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_normal_matrix_is_the_feature_operator():
    """x A^T W A (one product a CG iteration) equals JAX's matrix-free
    feature term, segment_sum of W (A x), within 1e-5."""
    import jax.numpy as jnp

    from livevisionkit_tpu.vision import mesh_motion as jmm

    idx, w4, a, _, wf, x = _case(4)
    got = x.reshape(2, -1) @ tmm._normal(a, wf)
    ij, wj = jnp.asarray(idx.numpy()), jnp.asarray(w4.numpy())
    xj = jnp.asarray(x.numpy())
    want = jmm._scatter(jmm._sample(xj, ij, wj) * jnp.asarray(wf.numpy())[:, None], ij, wj, NODES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_temporal_weight_matches_jax():
    """The per-node temporal weight lam_t / (1 + (s / s0)^2), s the
    features' support (the normal matrix's diagonal), against JAX's
    `temporal_diag` (segment_sum of wf w4^2), within 1e-6."""
    import jax
    import jax.numpy as jnp

    from livevisionkit_tpu.vision import mesh_motion as jmm

    rng = np.random.default_rng(5)
    pts = _points(rng)
    wf = rng.uniform(size=len(pts)).astype(np.float32)
    settings = tcfg.MeshMotionSettings()
    idx, w4 = tmm._bilinear_weights(_t(pts), MESH, SIZE)
    s = torch.diagonal(tmm._normal(tmm._operator(idx, w4, NODES), _t(wf)))
    got = settings.temporal_weight / (1.0 + (s / settings.temporal_support_scale) ** 2)
    ij, wj = jmm._bilinear_weights(jnp.asarray(pts), MESH, SIZE)
    sj = jax.ops.segment_sum((jnp.asarray(wf)[:, None] * wj * wj).reshape(-1), ij.reshape(-1),
                             num_segments=NODES)
    want = settings.temporal_weight / (1.0 + (sj / settings.temporal_support_scale) ** 2)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_products_under_vmap_equal_per_stream_calls():
    """A, A^T r and the normal matrix batched over 4 streams (each its own
    points, as `MultiStreamFilter`'s mesh tick runs them) against each
    stream's own call."""
    cases = [_case(10 + s) for s in range(4)]
    idx, w4, a, res, wf, _ = (torch.stack(parts) for parts in zip(*cases))

    def parts(idx, w4, res, wf):
        op = tmm._operator(idx, w4, NODES)
        return op, tmm._scatter(res, op), tmm._normal(op, wf)

    ops, scat, norm = torch.func.vmap(parts)(idx, w4, res, wf)
    assert torch.equal(ops, a)
    for s, (_, _, a_s, res_s, wf_s, _) in enumerate(cases):
        torch.testing.assert_close(scat[s], tmm._scatter(res_s, a_s), rtol=0, atol=1e-6)
        torch.testing.assert_close(norm[s], tmm._normal(a_s, wf_s), rtol=0, atol=1e-6)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the atomic sum's order shows only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_solves_on_the_card_are_bit_equal(cuda):
    """The flagship's feature count (17x30 = 510) over a 16x16 mesh at the
    272x480 detection size, with a warm start: two solves on the same
    inputs give the same bits."""
    size, mesh = (272, 480), (16, 16)
    rng = np.random.default_rng(5)
    dst = _points(rng, 510, size)
    src = dst + rng.normal(scale=2.0, size=dst.shape).astype(np.float32)
    wts = (rng.uniform(size=510) > 0.2).astype(np.float32)
    glob = rng.normal(scale=1e-3, size=(2, *mesh)).astype(np.float32)
    prev = rng.normal(scale=1e-3, size=(2, *mesh)).astype(np.float32)
    args = [_t(v).to(cuda) for v in (src, dst, wts)]
    runs = []
    for _ in range(2):
        field, inl, res = tmm.estimate(*args, twf.WarpField(offsets=_t(glob).to(cuda)), size,
                                       tcfg.MeshMotionSettings(),
                                       twf.WarpField(offsets=_t(prev).to(cuda)), 1.0)
        runs.append((field.offsets, inl, res))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mesh_graph_replay_bit_equal_to_eager(cuda):
    """The mesh stabilizer (`stabilization_preset(model="field")`) at 1080p,
    12 frames: every output and correction of the replayed graph bit-equal
    to the op-by-op step's."""
    filt = lt.StabilizationFilter(settings=stabilization_preset(model="field"))
    h, w = 1080, 1920
    spec = lt.FrameSpec(h, w, 3, lt.PixelFormat.YUV)
    rng = np.random.default_rng(6)
    tex = torch.from_numpy(rng.uniform(size=(h + 64, w + 64)).astype(np.float32)).to(cuda)
    tex = torch.nn.functional.avg_pool2d(tex[None, None], 5, 1, 2)[0, 0]
    pos = np.clip(np.cumsum(rng.integers(-3, 4, size=(12, 2)), axis=0) + 32, 0, 63)
    eager, state = filt.init(spec, device=cuda), filt.init(spec, device=cuda)
    step = compiled.jit_step(filt.step)
    for t, (y, x) in enumerate(pos):
        luma = tex[y:y + h, x:x + w]
        px = torch.stack([luma, torch.full_like(luma, 0.5), torch.full_like(luma, 0.5)])
        frame = lt.Frame(pixels=px, timestamp=torch.full((), t / 30.0, device=cuda),
                         valid=torch.ones((), dtype=torch.bool, device=cuda), format=lt.PixelFormat.YUV)
        eager, want = filt.step(eager, frame)
        state, out = step(state, frame)
        assert torch.equal(out.pixels, want.pixels) and torch.equal(out.valid, want.valid)
        assert torch.equal(state.correction.offsets, eager.correction.offsets)
    assert step.n_graphs == 1 and bool(out.valid)
