"""The traffic generator's schedules and seeds, and the device-made
frames."""

import time

import numpy as np
import pytest
import torch

from vbench import manifest as mf
from vbench.drive import Cell, clip_lengths, clip_schedule, pool_frames
from vbench.frames import (FramePool, _hue_bin_f64, cell_map, draw_picks,
                           mid_bin_colors)
from vbench.reference.flagship import histogram_cells

BIG_SEED = 2 ** 31 + 12345


def _cell(traffic, seed=BIG_SEED, height=1080, width=1920):
    config = {"frame": {"height": height, "width": width}}
    return Cell("x", config, traffic, seed, 10.0, False, "cpu")


def test_clip_lengths_same_set_every_seed():
    t = mf.traffic("offline-clips")
    lengths = clip_lengths(t)
    lo, hi = t["clip_frames"]
    assert len(lengths) == t["clip_lengths"]
    assert all(lo <= n <= hi + 1 for n in lengths)
    assert all(n % t["ragged_of"] for n in lengths)
    firsts = []
    for seed in (1, BIG_SEED):
        sched = clip_schedule(_cell(t, seed), t["pool_frames"])
        one_pass = [next(sched) for _ in lengths]
        assert sorted(n for n, _ in one_pass) == sorted(lengths)
        assert all(0 <= s and s + n <= t["pool_frames"]
                   for n, s in one_pass)
        firsts.append(one_pass)
    assert firsts[0] != firsts[1]
    again = clip_schedule(_cell(t, BIG_SEED), t["pool_frames"])
    assert [next(again) for _ in lengths] == firsts[1]


def test_pool_sizes():
    live = mf.traffic("live-30fps")
    assert pool_frames(_cell(live)) == 64
    assert pool_frames(_cell(live, height=2160, width=3840)) == 32
    for name in ("offline-clips", "pod-closed-8"):
        t = mf.traffic(name)
        assert pool_frames(_cell(t)) * 1080 * 1920 * 3 > 50e6   # > L2


def test_colors_are_mid_bin():
    colors, bins = mid_bin_colors()
    x = _hue_bin_f64(*(colors.astype(np.float64) / 255.0).T, bins=360)
    assert np.all(np.floor(x) == bins)
    assert np.all(np.abs(x - bins - 0.5) < 0.25)
    assert colors.max(1).min() >= 160 and colors.min(1).max() <= 60


def test_picks_avoid_ema_ties():
    _colors, bins = mid_bin_colors()
    picks = draw_picks(BIG_SEED, 200, 16, bins)
    prev = np.zeros(16, np.int64)
    for row in picks:
        b = bins[row]
        assert np.all((9 * prev + b) % 10 != 0)
        prev = (9 * prev + b) // 10
    assert np.array_equal(picks, draw_picks(BIG_SEED, 200, 16, bins))
    assert not np.array_equal(picks, draw_picks(BIG_SEED + 1, 200, 16,
                                                bins))


def test_pool_frames_are_the_seeds():
    a = FramePool(BIG_SEED, 6, 80, 160, 3, 4, 360, "cpu")
    b = FramePool(BIG_SEED, 6, 80, 160, 3, 4, 360, "cpu")
    host = a.to_host(block=4)
    assert host.shape == (6, 80, 160, 3) and host.dtype == np.uint8
    assert np.array_equal(host, b.to_host())
    assert torch.equal(a.on_device([5, 2]),
                       torch.as_tensor(host[[5, 2]]))
    c = FramePool(BIG_SEED + 1, 6, 80, 160, 3, 4, 360, "cpu")
    assert not np.array_equal(host, c.to_host())
    a.release()                     # the tables are made again on use
    assert a._tables is None
    assert torch.equal(a.on_device([5, 2]),
                       torch.as_tensor(host[[5, 2]]))


def test_every_cell_is_one_color():
    """Each histogram cell of a frame is one flat colour, on the cell map
    the reference's histogram uses."""
    pool = FramePool(7, 2, 160, 320, 3, 4, 360, "cpu")
    frames = pool.to_host()
    cells = cell_map(160, 320, 3, 4)
    ref_cells = histogram_cells(20, 40, 4, "cpu")
    assert np.array_equal(cells[::8, ::8], ref_cells.numpy())
    for f in frames:
        for c in range(16):
            px = f[cells == c]
            assert (px == px[0]).all()


class _FakeTracer:
    """Traces whose first ``bad`` sub-windows lose their kernels."""

    def __init__(self, bad: int):
        self.bad, self.attempts, self.frames = bad, 0, []
        self.complete = False

    @property
    def wanted(self):
        return not self.complete and self.attempts < 3

    def start(self, settle_s):
        self.attempts += 1

    def stop(self, frames):
        self.frames.append(frames)
        self.complete = self.attempts > self.bad


@pytest.mark.parametrize("bad,attempts,room", [(0, 1, 1.0), (1, 2, 1.0),
                                               (5, 3, 1.0), (5, 1, 0.03)])
def test_a_lost_trace_is_traced_again(bad, attempts, room):
    """A paced run traces another sub-window while the last one lost its
    kernels, up to three, and only while one fits before the window's
    end."""
    from vbench.drive import _trace_paced
    tracer = _FakeTracer(bad)
    t = {"trace_settle_s": 0.0, "trace_seconds": 0.02}
    count = iter(range(100))
    t0 = time.perf_counter()
    _trace_paced(tracer, t, t0, t0 + room, lambda: next(count))
    assert tracer.attempts == attempts
    assert tracer.frames == [1] * attempts
