"""The deblocker's kernels (K8, csrc/deblock.cu): the median-selection
networks and the custom ops on the CPU, and on the card the median kernel
against `median_blur_plain` bit for bit and the two deblocker kernels
against `deblock_plain`.

The `cuda` tests need a card and skip without one (a CUDA kernel has no CPU
mode).  The file imports no JAX, so on the card it runs without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_deblock_kernel.py

The deblocker's keep map is min(floor(255 measure), L) / L per block: where
255 measure lies within NEAR of an integer 1..L (u8-quantized input puts
blocks exactly there), two sums taken in another order may floor apart.
Those blocks are excluded, and counted, by the plain measure, and the
outputs compared away from them grown by half a block, the reach of the
keep map's bilinear upsample (tests/test_torch_enhancement.py's protocol).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import livevisionkit_tpu_torch as lt
from livevisionkit_tpu_torch.filters import deblocking
from livevisionkit_tpu_torch.ops import color, resample
from livevisionkit_tpu_torch.ops.cuda_kernels import deblock as deblock_kernel
from livevisionkit_tpu_torch.ops.cuda_kernels import median_net

BLOCK, SCALING, KSIZE, LEVELS = 16, 4, 5, 3  # DeblockingFilterSettings' defaults
NEAR = 1e-4  # |255 measure - integer| below which a block's floor may flip
HEADER = Path(__file__).resolve().parents[1] / "livevisionkit_tpu_torch" / "csrc" / "median_net.cuh"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the deblocker kernels have no CPU mode")
    return torch.device("cuda", 0)


def _texture(rng, c, h, w):
    """c planes of blurred noise in [0.2, 0.8] with bright and dark squares."""
    img = rng.uniform(0.2, 0.8, size=(c, h, w)).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 1) + np.roll(img, -1, 1) + np.roll(img, 1, 2)
               + np.roll(img, -1, 2)) / 5.0
    for _ in range(max(4, h * w // 2500)):
        y, x, s = rng.integers(0, h - 4), rng.integers(0, w - 4), int(rng.integers(3, 12))
        img[:, y:y + s, x:x + s] = rng.uniform(0.85, 1.0) if rng.uniform() > 0.5 else rng.uniform(0, 0.1)
    return img


def _blocky(seed, c, h, w):
    """u8-quantized (c, h, w) f32 frame: each whole 16 x 16 block of a
    texture left textured (1/2), flattened to its mean (3/8), or split
    into halves 2/255 apart (1/8: 255 measure exactly 1, the floor's
    trap)."""
    rng = np.random.default_rng(seed)
    tex = _texture(rng, c, h, w)
    fh, fw = h // BLOCK * BLOCK, w // BLOCK * BLOCK
    blocks = tex[:, :fh, :fw].reshape(c, fh // BLOCK, BLOCK, fw // BLOCK, BLOCK)
    kind = rng.choice(3, size=(fh // BLOCK, fw // BLOCK), p=(0.5, 0.375, 0.125))[None, :, None, :, None]
    flat = np.broadcast_to(blocks.mean(axis=(2, 4), keepdims=True), blocks.shape)
    split = np.broadcast_to(np.round(blocks.mean(axis=(0, 2, 4), keepdims=True) * 255.0) / 255.0,
                            blocks.shape).copy()
    split[..., BLOCK // 2:] += 2.0 / 255.0
    tex[:, :fh, :fw] = np.where(kind == 1, flat, np.where(kind == 2, split, blocks)).reshape(c, fh, fw)
    return torch.from_numpy(np.round(np.clip(tex, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0)


def _away(px, fmt):
    """(h, w) bool: the pixels farther than half a block from every block
    whose plain 255 measure (over the edge-padded frame, on px's device)
    is within NEAR of an integer 1..LEVELS; and the count of such blocks."""
    _, h, w = px.shape
    ph, pw = -(-h // BLOCK) * BLOCK, -(-w // BLOCK) * BLOCK
    padded = F.pad(px[None], (0, pw - w, 0, ph - h), mode="replicate")[0]
    m = deblocking.block_measure(color.luma(padded, fmt), BLOCK) * 255.0
    k = torch.round(m)
    near = ((m - k).abs() < NEAR) & (k >= 1) & (k <= LEVELS)
    hit = near.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)[None, None].float()
    r = BLOCK // 2
    grown = F.max_pool2d(hit, 2 * r + 1, stride=1, padding=r)[0, 0] > 0
    return ~grown[:h, :w], int(near.sum())


# ------------------------------------------------------------- on the CPU


def _zero_one_inputs(n: int) -> list[np.ndarray]:
    """Wire i of all 2^n 0-1 inputs, 64 inputs to a uint64 word: input j
    holds bit i of j on wire i."""
    words = max(1, (1 << n) // 64)
    j = np.arange(words, dtype=np.uint64)
    wires = []
    for i in range(n):
        if i < 6:
            bits = (np.arange(64, dtype=np.uint64) >> np.uint64(i)) & np.uint64(1)
            wires.append(np.full(words, np.bitwise_or.reduce(bits << np.arange(64, dtype=np.uint64)),
                                 dtype=np.uint64))
        else:
            wires.append(np.where((j >> np.uint64(i - 6)) & np.uint64(1), ~np.uint64(0),
                                  np.uint64(0)).astype(np.uint64))
    return wires


def _majority(n: int) -> np.ndarray:
    """The median of each of the 2^n 0-1 inputs (1 where more than n // 2
    of its bits are set), packed as `_zero_one_inputs` packs them."""
    out = []
    for start in range(0, 1 << n, 1 << 20):
        idx = np.arange(start, min(start + (1 << 20), 1 << n), dtype=np.uint32)
        count = np.zeros(idx.shape, np.uint8)
        for i in range(n):
            count += ((idx >> np.uint32(i)) & np.uint32(1)).astype(np.uint8)
        out.append(count > n // 2)
    return np.packbits(np.concatenate(out), bitorder="little").view(np.uint64)


@pytest.mark.parametrize("ksize", median_net.KSIZES)
def test_median_networks_select_the_median(ksize):
    """Each network of csrc/median_net.cuh leaves the median on wire n // 2:
    for 3 x 3 and 5 x 5 on every 0-1 input (the 0-1 principle: then on
    every input), for 7 x 7 (2^49 0-1 inputs) on 20,000 random vectors
    with ties, against np.median.  A half-read exchange computes only the
    result that is read."""
    n = ksize * ksize
    net = median_net.median_network(n)
    if n <= 25:
        wires = _zero_one_inputs(n)
        for a, b, lo, hi in net:
            wa, wb = wires[a], wires[b]
            if lo:
                wires[a] = wa & wb
            if hi:
                wires[b] = wa | wb
        assert np.array_equal(wires[n // 2], _majority(n))
    else:
        v = np.random.default_rng(7).integers(0, 12, size=(n, 20000)).astype(np.float32)
        want = np.median(v, axis=0)
        for a, b, lo, hi in net:
            va, vb = v[a].copy(), v[b].copy()
            if lo:
                v[a] = np.minimum(va, vb)
            if hi:
                v[b] = np.maximum(va, vb)
        assert np.array_equal(v[n // 2], want)


def test_median_header_is_the_generated_one():
    """csrc/median_net.cuh is what median_net.header() writes: the networks
    the kernels run are the ones tested above."""
    assert HEADER.read_text() == median_net.header()


@pytest.mark.parametrize("fmt,c,size", [("YUV", 3, (72, 120)), ("BGR", 3, (40, 56)),
                                        ("GRAY", 1, (64, 96))])
def test_deblock_op_on_cpu_is_the_plain_composition(fmt, c, size):
    """``lvk::deblock`` (the DeblockingFilter's step) on CPU tensors is
    `deblock_plain` bit for bit, and under vmap over streams
    `deblock_batched_plain`; ``lvk::median_blur`` on CPU tensors, solo and
    under vmap, is `median_blur_plain`."""
    f = getattr(lt.PixelFormat, fmt)
    px = _blocky(3, c, *size)
    _, out = lt.DeblockingFilter().step((), lt.Frame.create(px, fmt=f))
    assert torch.equal(out.pixels, deblocking.deblock_plain(px, f, BLOCK, SCALING, KSIZE, LEVELS))
    stack = torch.stack([px, px.flip(-1), px.flip(-2)])
    got = torch.func.vmap(lambda p: deblocking._deblock_op(p, f.value, BLOCK, SCALING, KSIZE, LEVELS))(stack)
    assert torch.equal(got, deblocking.deblock_batched_plain(stack, f, BLOCK, SCALING, KSIZE, LEVELS))
    small = resample.avg_pool(px[:, :size[0] // 4 * 4, :size[1] // 4 * 4], 4)
    assert torch.equal(resample.median_blur(small, 5), resample.median_blur_plain(small, 5))
    pair = torch.stack([small, small.flip(-1)])
    got = torch.func.vmap(lambda t: resample.median_blur(t, 5))(pair)
    assert all(torch.equal(got[i], resample.median_blur_plain(pair[i], 5)) for i in range(2))


def test_kernel_wrappers_reject_on_the_cpu():
    """The wrappers take f32 CUDA tensors only: another dtype raises a
    TypeError, a CPU tensor a ValueError."""
    x = torch.rand(3, 32, 32)
    with pytest.raises(TypeError):
        deblock_kernel.median_blur(x.double(), 5)
    with pytest.raises(ValueError):
        deblock_kernel.median_blur(x, 5)
    with pytest.raises(TypeError):
        deblock_kernel.deblock(x.half(), None, BLOCK, SCALING, KSIZE, LEVELS)
    with pytest.raises(ValueError):
        deblock_kernel.deblock(x, None, BLOCK, SCALING, KSIZE, LEVELS)


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(540, 960), (17, 23), (9, 11), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("ksize", [3, 5])
def test_median_kernel_equals_plain(cuda, ksize, c, size):
    """The median kernel against `median_blur_plain` on the card, bit for
    bit, on inputs in [0, 1]; a side not above ksize // 2 (2 x 2 at 5 x 5,
    which reflect padding cannot take either) raises."""
    x = torch.from_numpy(np.random.default_rng(ksize * 10 + c).uniform(0, 1, (c, *size))
                         .astype(np.float32)).to(cuda)
    if min(size) <= ksize // 2:
        with pytest.raises(ValueError):
            deblock_kernel.median_blur(x, ksize)
        return
    before = deblock_kernel.median_blur.launches
    got = resample.median_blur(x, ksize)
    assert deblock_kernel.median_blur.launches == before + 1
    want = resample.median_blur_plain(x, ksize)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_median_kernel_7_and_vmap(cuda):
    """7 x 7 bit for bit, and ``lvk::median_blur`` under vmap over 3
    streams one launch equal to the solo calls."""
    x = torch.rand(3, 2, 45, 70, device=cuda)
    assert torch.equal(deblock_kernel.median_blur(x[0].contiguous(), 7),
                       resample.median_blur_plain(x[0], 7))
    before = deblock_kernel.median_blur.launches
    got = torch.func.vmap(lambda t: resample.median_blur(t, 5))(x)
    assert deblock_kernel.median_blur.launches == before + 1
    for s in range(3):
        assert torch.equal(got[s], resample.median_blur_plain(x[s], 5))


DEBLOCK_CASES = [((2160, 3840), "YUV", 3), ((1080, 1920), "BGR", 3), ((72, 120), "GRAY", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("size,fmt,c", DEBLOCK_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_deblock_kernel_matches_plain(cuda, size, fmt, c):
    """The two deblocker kernels (through DeblockingFilter.step) against
    `deblock_plain` on the card within 1e-6 away from the floor-trap
    blocks, which are counted and stay a minority (at least a third of the
    pixels compared); 1080 rows pad to 1088 and leave a partial border,
    which passes through exactly."""
    f = getattr(lt.PixelFormat, fmt)
    px = _blocky(11, c, *size).to(cuda)
    before = deblock_kernel.deblock.launches
    _, out = lt.DeblockingFilter().step((), lt.Frame.create(px, fmt=f))
    assert deblock_kernel.deblock.launches == before + 1
    want = deblocking.deblock_plain(px, f, BLOCK, SCALING, KSIZE, LEVELS)
    away, n_near = _away(px, f)
    n_blocks = -(-size[0] // BLOCK) * -(-size[1] // BLOCK)
    err = float((out.pixels - want).abs()[:, away].max())
    print(f"{size} {fmt}: max|err| {err:.3e} away from {n_near} of {n_blocks} near blocks")
    assert err <= 1e-6
    assert n_near <= n_blocks // 5 and float(away.float().mean()) >= 1 / 3
    fh, fw = size[0] // BLOCK * BLOCK, size[1] // BLOCK * BLOCK
    assert torch.equal(out.pixels[:, fh:], px[:, fh:]) and torch.equal(out.pixels[:, :, fw:], px[:, :, fw:])
    assert float((out.pixels - px).abs().max()) > 1e-3  # it smooths something


@pytest.mark.cuda
def test_deblock_kernel_batched_equals_solo(cuda):
    """MultiStreamFilter over the deblocker: vmap over 3 streams is one
    call of the kernels, equal bit for bit to the solo calls; a frame
    broadcast over the streams (stream stride 0) too."""
    from livevisionkit_tpu_torch.parallel.streams import MultiStreamFilter

    px = torch.stack([_blocky(20 + s, 3, 1080, 1920) for s in range(3)]).to(cuda)
    f = lt.DeblockingFilter()
    frames = lt.Frame(pixels=px, timestamp=torch.zeros(3, device=cuda),
                      valid=torch.ones(3, dtype=torch.bool, device=cuda), format=lt.PixelFormat.YUV)
    multi = MultiStreamFilter(f, 3)
    before = deblock_kernel.deblock.launches
    _, out = multi.step(multi.init(lt.FrameSpec(1080, 1920, 3, lt.PixelFormat.YUV), device=cuda), frames)
    assert deblock_kernel.deblock.launches == before + 1
    for s in range(3):
        _, want = f.step((), lt.Frame.create(px[s], fmt=lt.PixelFormat.YUV))
        assert torch.equal(out.pixels[s], want.pixels)
    shared = deblock_kernel.deblock(px[:1].expand(3, -1, -1, -1), None, BLOCK, SCALING, KSIZE, LEVELS)
    assert all(torch.equal(shared[s], out.pixels[0]) for s in range(3))


@pytest.mark.cuda
def test_deblock_kernel_in_a_captured_graph(cuda):
    """The deblocker captured into a CUDA graph gives the op-by-op result
    on replay, and launches give the same bits each time."""
    frame = lt.Frame.create(_blocky(5, 3, 1080, 1920).to(cuda), fmt=lt.PixelFormat.YUV)
    f = lt.DeblockingFilter()

    def run():
        return f.step((), frame)[1].pixels

    eager = run()
    assert torch.equal(run(), eager)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    before = deblock_kernel.deblock.launches
    with torch.cuda.graph(graph):
        out = run()
    assert deblock_kernel.deblock.launches == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert deblock_kernel.deblock.launches == before + 1


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    """Wrong dtype, device, ksize and shape raise before any launch."""
    x = torch.rand(3, 64, 64, device=cuda)
    for bad, err in ((x.double(), TypeError), (x.cpu(), ValueError)):
        with pytest.raises(err):
            deblock_kernel.median_blur(bad, 5)
        with pytest.raises(err):
            deblock_kernel.deblock(bad, None, BLOCK, SCALING, KSIZE, LEVELS)
    for k in (1, 4, 9):
        with pytest.raises(ValueError):
            deblock_kernel.median_blur(x, k)
        with pytest.raises(ValueError):
            deblock_kernel.deblock(x, None, BLOCK, SCALING, k, LEVELS)
        with pytest.raises(ValueError):  # the filter's settings are not validated: the wrapper says
            lt.DeblockingFilter(lt.DeblockingFilterSettings(filter_size=k)).step(
                (), lt.Frame.create(x, fmt=lt.PixelFormat.YUV))
    with pytest.raises(ValueError):
        deblock_kernel.median_blur(x[0, 0], 5)  # 1-D is no image
    with pytest.raises(ValueError):
        deblock_kernel.median_blur(x[:, :, ::2], 5)  # not contiguous
    with pytest.raises(ValueError):
        deblock_kernel.deblock(torch.rand(5, 64, 64, device=cuda), None, BLOCK, SCALING, KSIZE, LEVELS)
    with pytest.raises(ValueError):
        deblock_kernel.deblock(x, (0.3, 0.6, 0.1), BLOCK, 3, KSIZE, LEVELS)  # 16 % 3
    with pytest.raises(ValueError):
        deblock_kernel.deblock(x[:1], (0.3, 0.6, 0.1), BLOCK, SCALING, KSIZE, LEVELS)
    with pytest.raises(ValueError):
        deblock_kernel.deblock(torch.rand(3, 8, 8, device=cuda), None, BLOCK, 8, KSIZE, LEVELS)
