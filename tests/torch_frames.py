"""Structured u8 test clips for the PyTorch port's parity tests (numpy only,
so the GPU-only tests can use it without jax)."""

import numpy as np


def _mid_bin_colors(seed: int = 1):
    """Saturated, bright u8 colours whose HSI hue lies in the middle half of
    a histogram bin (f64 formula of convolveFeatures.metal:14-38), so no
    f32 evaluation order can move them across a bin edge.
    Returns (colors u8[N, 3], bins int[N])."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (400000, 3)).astype(np.float64)
    c = c[(c.max(1) >= 160) & (c.min(1) <= 60)]
    r, g, b = (c / 255.0).T
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    th = np.arccos(np.clip(num / den, -1.0, 1.0))
    x = np.where(b <= g, th, 2 * np.pi - th) / (2 * np.pi) * 359
    keep = np.abs(x - np.floor(x) - 0.5) < 0.25
    return c[keep].astype(np.uint8), np.floor(x[keep]).astype(np.int64)


_COLORS, _BINS = _mid_bin_colors()


def structured_frames(seed: int, T: int, H: int, W: int, mip: int = 3,
                      grid: int = 4) -> np.ndarray:
    """u8 frames (T, H, W, 3) of structured hue blocks: every one of the
    grid x grid histogram cells is one mid-bin colour per frame, so each
    cell passes the count gate and the hues really move.

    Each colour is chosen so that the default 0.9 / 0.1 hue EMA never lands
    on an exact integer: there the truncation hangs on the last ulp, which
    XLA:CPU's FMA contraction decides differently from one fusion to the
    next (the JAX package's own scan and chunked paths disagree there).
    """
    rng = np.random.default_rng(seed)
    hm, wm = H >> mip, W >> mip
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    cell = row_of_x[None, :] * grid + col_of_y[:, None]
    cell = np.repeat(np.repeat(cell, 1 << mip, 0), 1 << mip, 1)
    prev = np.zeros(grid * grid, np.int64)
    frames = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        pick = rng.integers(len(_COLORS), size=grid * grid)
        for k in range(grid * grid):
            while (9 * prev[k] + _BINS[pick[k]]) % 10 == 0:
                pick[k] = rng.integers(len(_COLORS))
            prev[k] = (9 * prev[k] + _BINS[pick[k]]) // 10
        frames[t, :cell.shape[0], :cell.shape[1]] = _COLORS[pick][cell]
    return frames
