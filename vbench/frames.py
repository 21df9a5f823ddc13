"""Frames of the benchmark's traffic, made on the device from a seed.

A structured scene: every histogram cell of every frame is one flat block
of a saturated, bright u8 colour whose HSI hue lies in the middle half of
a hue bin, so no float32 evaluation order can move a pixel across a bin
edge, and every cell passes the count gate.  The colours change from
frame to frame, so the hues, the partials and the gradient statistics
move.  Each colour is drawn so that the 0.9 / 0.1 hue EMA of the frames
in order never lands on an exact integer, where the truncation would hang
on the last ulp.  (The same scene as the program's test clips, made here
with no code of the program or its tests.)

The picks (a few integers a frame) are drawn on the host from the seed;
the pixels are gathered on the device in blocks and copied once into
ordinary pageable host memory, which is what a decoder hands the API.
"""

from __future__ import annotations

import numpy as np
import torch

#: Draws of the candidate colours (a constant palette for every seed).
_PALETTE_SEED = 1
_PALETTE_DRAWS = 400000


def _hue_bin_f64(r, g, b, bins: int):
    """The float64 hue of convolveFeatures.metal:14-38 in bins (h * (bins
    - 1), whose floor is the bin) of RGB in [0, 1]."""
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    th = np.arccos(np.clip(num / np.where(den > 0, den, 1.0), -1.0, 1.0))
    return np.where(b <= g, th, 2 * np.pi - th) / (2 * np.pi) * (bins - 1)


def mid_bin_colors(bins: int = 360):
    """Saturated, bright u8 colours whose hue lies within a quarter bin of
    a bin's centre.  Returns (colors u8[N, 3], bin of each int64[N])."""
    rng = np.random.default_rng(_PALETTE_SEED)
    c = rng.integers(0, 256, (_PALETTE_DRAWS, 3)).astype(np.float64)
    c = c[(c.max(1) >= 160) & (c.min(1) <= 60)]
    x = _hue_bin_f64(*(c / 255.0).T, bins=bins)
    keep = np.abs(x - np.floor(x) - 0.5) < 0.25
    return c[keep].astype(np.uint8), np.floor(x[keep]).astype(np.int64)


def draw_picks(seed: int, n: int, cells: int, bins_of: np.ndarray
               ) -> np.ndarray:
    """The colour of every cell of ``n`` frames, int64[n, cells]: drawn
    from ``seed``, redrawn where ``(9 prev + bin) % 10 == 0`` (an exact
    integer under the 0.9 / 0.1 EMA of the frames in order)."""
    rng = np.random.default_rng(seed)
    prev = np.zeros(cells, np.int64)
    picks = np.empty((n, cells), np.int64)
    for t in range(n):
        pick = rng.integers(len(bins_of), size=cells)
        for k in range(cells):
            while (9 * prev[k] + bins_of[pick[k]]) % 10 == 0:
                pick[k] = rng.integers(len(bins_of))
            prev[k] = (9 * prev[k] + bins_of[pick[k]]) // 10
        picks[t] = pick
    return picks


def cell_map(height: int, width: int, mip: int, grid: int) -> np.ndarray:
    """The histogram cell of every full-resolution pixel of the region the
    mip covers (the kernel's rotated coordinates, convolveFeatures.metal
    :155-157): int64[hm << mip, wm << mip]."""
    hm, wm = height >> mip, width >> mip
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    cell = row_of_x[None, :] * grid + col_of_y[:, None]
    return np.repeat(np.repeat(cell, 1 << mip, 0), 1 << mip, 1)


class FramePool:
    """``n`` structured u8 frames (n, height, width, 3) drawn from
    ``seed``; frame ``i`` is a pure function of (seed, i)."""

    def __init__(self, seed: int, n: int, height: int, width: int,
                 mip: int, grid: int, bins: int, device):
        self.n, self.height, self.width = n, height, width
        self.device = torch.device(device)
        colors, bins_of = mid_bin_colors(bins)
        self.picks = draw_picks(seed, n, grid * grid, bins_of)
        self._colors = torch.as_tensor(colors, device=self.device)
        self._picks = torch.as_tensor(self.picks, device=self.device)
        self._cells = torch.as_tensor(cell_map(height, width, mip, grid),
                                      device=self.device)

    def on_device(self, index) -> torch.Tensor:
        """Frames ``index`` (a sequence of pool indices) as u8 (len,
        height, width, 3) on the device."""
        idx = torch.as_tensor(np.asarray(index, np.int64),
                              device=self.device)
        palette = self._colors[self._picks[idx]]          # (B, cells, 3)
        out = torch.zeros((len(idx), self.height, self.width, 3),
                          dtype=torch.uint8, device=self.device)
        hc, wc = self._cells.shape
        out[:, :hc, :wc] = palette[:, self._cells]
        return out

    def to_host(self, block: int = 32) -> np.ndarray:
        """The whole pool in pageable host memory (n, height, width, 3)."""
        host = np.empty((self.n, self.height, self.width, 3), np.uint8)
        for start in range(0, self.n, block):
            stop = min(self.n, start + block)
            host[start:stop] = self.on_device(range(start, stop)).cpu() \
                .numpy()
        return host
