"""The traffic generator is a function of the seed, and the paced reader's
due times are its schedule, whatever the consumer does."""

import time

import numpy as np
import torch

from tiny import BENCH  # noqa: F401

from drivers.live import paced_reader
from drivers.multi import Reservoir
from harness import manifest, render

TRAFFIC = manifest.traffic("clip_offline_blocky")


def _stream(seed, stream=0):
    return render.make_stream(seed, stream, 6, (72, 96), TRAFFIC, "cpu")


def test_same_seed_same_clip():
    a, b = _stream(2**31 + 11), _stream(2**31 + 11)
    assert torch.equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.path.poses, b.path.poses)


def test_seed_and_stream_change_content_not_shape():
    a, b, c = _stream(5), _stream(6), _stream(5, stream=1)
    assert a.frames.shape == b.frames.shape == c.frames.shape
    assert not torch.equal(a.frames, b.frames) and not torch.equal(a.frames, c.frames)


def test_ring_sizes_scale_with_the_frame():
    clip = manifest.traffic("clip_offline")
    assert render.ring_frames(clip, (1080, 1920)) == 480
    assert render.ring_frames(clip, (2160, 3840)) == 120


def test_path_is_closed_and_bounded():
    path = render.camera_path(np.random.default_rng(3), 480, (1080, 1920), manifest.traffic("clip_offline"))
    # The wrap from the last pose to the first is one more shake: no larger
    # than the steps inside the ring.
    steps = np.abs(np.diff(path.poses[:, :2, 2], axis=0)).max()
    wrap = np.abs(path.poses[0, :2, 2] - path.poses[-1, :2, 2]).max()
    assert wrap <= steps
    assert path.poses[:, :2, 2].min() > 0 and path.poses[:, :2, 2].max() < 2 * path.margin


def test_paced_reader_due_times_do_not_slip():
    fps, closed, total = 200.0, 3, 23
    due = np.zeros(total)
    took = []
    for k, (frame, ts) in enumerate(paced_reader(list(range(7)), total, closed, fps, due)):
        took.append(time.perf_counter())
        assert frame == k % 7 and ts == k / fps
        if k == 8:
            time.sleep(0.05)  # the consumer stalls for ten slots
    paced = due[closed:]
    np.testing.assert_allclose(np.diff(paced), 1.0 / fps, rtol=0, atol=1e-9)
    # Inputs due during the stall are yielded late, at once, not re-timed.
    assert took[12] - due[12] > 0.02
    assert all(t >= d - 1e-4 for t, d in zip(took[closed:], paced))


def test_reservoir_draws_from_the_whole_window():
    # The picks are a function of the seed, and late outputs are drawn as
    # often as early ones.
    def draw(seed):
        res = Reservoir(np.random.default_rng(seed), 3)
        for g in range(600):
            res.offer(g, np.full(2, g))
        assert sorted(res.kept) == sorted(res.order) and len(res.kept) == 3
        assert all(int(px[0]) == g for g, px in res.kept.items())
        return sorted(res.kept)

    assert draw(7) == draw(7)
    picks = np.concatenate([draw(seed) for seed in range(400)])
    assert abs(np.mean(picks >= 300) - 0.5) < 0.06
