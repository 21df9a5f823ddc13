"""Frame feature extraction — the PyTorch port of
:mod:`vaudio.vision.features`.

Channel planes in image orientation, with the kernels' rotated indexing
folded into cell arithmetic, as in the JAX package.  Every function takes
a leading frame dimension where the JAX package ``vmap``s a per-frame one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from vaudio_torch.config import AuralizerConfig
from vaudio_torch.ops import pool_kernel

_TWO_PI = float(np.float32(2.0 * np.pi))

# Abramowitz & Stegun 4.4.46: acos(x) = sqrt(1-x) * P7(x) on [0, 1].
_ACOS_COEFFS = tuple(float(np.float32(c)) for c in (
    1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
    0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911))


# ---------------------------------------------------------------------------
# Color space
# ---------------------------------------------------------------------------

def acos_poly(x):
    """Polynomial arccos (max abs error 2e-8 rad over [-1, 1])."""
    a = torch.abs(x)
    p = a * _ACOS_COEFFS[-1] + _ACOS_COEFFS[-2]
    for c in _ACOS_COEFFS[-3::-1]:
        p = p * a + c
    r = torch.sqrt(torch.clamp(1.0 - a, min=0.0)) * p
    return torch.where(x >= 0.0, r, float(np.float32(np.pi)) - r)


# fdlibm acosf constants, as the JAX package's vision kernel carries them
# (vaudio/ops/vision_kernel.py:60-65).
_PIO2_HI = float(np.float32(1.5707962513e+00))
_PIO2_LO = float(np.float32(7.5497894159e-08))
_PS0 = float(np.float32(1.6666586697e-01))
_PS1 = float(np.float32(-4.2743422091e-02))
_PS2 = float(np.float32(-8.6563630030e-03))
_QS1 = float(np.float32(-7.0662963390e-01))


def _r_poly(z):
    p = z * (_PS0 + z * (_PS1 + z * _PS2))
    q = 1.0 + z * _QS1
    return p / q


def acos_fdlibm(x):
    """float32 acos on [-1, 1] from sqrt, divide and polynomial only: the
    fdlibm algorithm the vision kernel K3 carries (vaudio/ops/
    vision_kernel.py:74-96), the sqrt of the x >= 0.5 branch split into a
    bit-truncated head and an exact tail.  Every branch is evaluated and
    one is selected, as in the JAX package."""
    ax = torch.abs(x)
    z1 = x * x
    r1 = _PIO2_HI - (x - (_PIO2_LO - x * _r_poly(z1)))
    z2 = (1.0 + x) * 0.5
    s2 = torch.sqrt(z2)
    r2 = 2.0 * (_PIO2_HI - (s2 + (_r_poly(z2) * s2 - _PIO2_LO)))
    z3 = (1.0 - x) * 0.5
    s3 = torch.sqrt(z3)
    df = (s3.view(torch.int32) & -4096).view(torch.float32)  # 0xFFFFF000
    denom = s3 + df
    pos = denom > 0.0
    c3 = torch.where(pos, (z3 - df * df)
                     / torch.where(pos, denom, torch.ones_like(denom)),
                     torch.zeros_like(denom))
    r3 = 2.0 * (df + (_r_poly(z3) * s3 + c3))
    return torch.where(ax < 0.5, r1, torch.where(x < 0.0, r2, r3))


def rgb_to_hsi_planes(r, g, b, fast_acos: bool = False, acos=None):
    """RGB planes -> (H, S, I) planes (convolveFeatures.metal:14-38); the
    acos argument is clamped to [-1, 1], grey pixels get hue 0.  ``acos``
    overrides the arccos (the vision kernel's :func:`acos_fdlibm`).  The
    division by 2 pi is a true division on every device (on CUDA a Python
    scalar divisor would become a multiply by its reciprocal)."""
    i = (r + g + b) * float(np.float32(1.0 / 3.0))
    min_val = torch.minimum(r, torch.minimum(g, b))
    one = torch.ones_like(i)
    s = torch.where(i > 0.0, 1.0 - min_val / torch.where(i > 0.0, i, one),
                    torch.zeros_like(i))

    num = 0.5 * ((r - g) + (r - b))
    den = torch.sqrt((r - g) * (r - g) + (r - b) * (g - b))
    safe_den = torch.where(den != 0.0, den, one)
    arg = torch.clamp(num / safe_den, -1.0, 1.0)
    if acos is None:
        acos = acos_poly if fast_acos else torch.arccos
    theta = acos(arg)
    h = torch.where(b <= g, theta, _TWO_PI - theta) \
        / torch.full((), _TWO_PI, device=theta.device)
    h = torch.where(den != 0.0, h, torch.zeros_like(h))
    return h, s, i


# ---------------------------------------------------------------------------
# Mip pyramid
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _pool_matrix(n: int, level: int) -> np.ndarray:
    """Banded box-averaging matrix: P[r, i] = 1/2^level for r in block i."""
    m = n >> level
    k = 1 << level
    p = np.zeros((n, m), np.float32)
    for i in range(m):
        p[i * k:(i + 1) * k, i] = 1.0 / k
    return p


def _pool_one_level(planes):
    """f32 (..., H, W) -> (..., H // 2, W // 2): one 2x2 mean level as the
    JAX package's two banded f32 products (0/0.5 entries, rows first) give
    it: each output of a product is fl(0.5 a + 0.5 b), the zero terms
    adding exactly; an odd last row or column is dropped."""
    h, w = planes.shape[-2:]
    x = planes[..., :h & ~1, :w & ~1]
    rows = x[..., 0::2, :] * 0.5 + x[..., 1::2, :] * 0.5
    return rows[..., 0::2] * 0.5 + rows[..., 1::2] * 0.5


def _quant_pool_level_u8(m):
    """One 8-bit mip level in integer arithmetic: u8 (..., H, W) ->
    u8 (..., H // 2, W // 2), the round-half-to-even of each 2x2 block mean
    (vaudio/vision/features.py:167-204): base = S >> 2 plus one where
    rem = S & 3 is 3, or 2 with an odd base."""
    h, w = m.shape[-2:]
    x = m[..., :h & ~1, :w & ~1].to(torch.int32)
    s = (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] + x[..., 0::2, 1::2]
         + x[..., 1::2, 1::2])
    base = s >> 2
    rem = s & 3
    bump = (rem == 3) | ((rem == 2) & ((base & 1) == 1))
    return (base + bump.to(torch.int32)).to(torch.uint8)


def _div(x, d: float):
    """x / d as a true division on every device (on CUDA, dividing by a
    Python float is a multiply by its reciprocal, 1 ulp off)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def mip_downsample_planes(planes, level: int, quantize: bool = False,
                          scale: float = 1.0, quantize_int8: bool = False):
    """(..., C, H, W) planes -> (..., C, H >> l, W >> l) box downsample
    (VisionEngine.swift:152-173,189-192); ``scale`` folds the u8 1/255.

    u8 planes take the exact integer path, kernel K1's planar entry
    (:func:`ops.pool_kernel.mip_pool_planes`; its plain version on the
    CPU); f32 planes the two banded f32 matmuls of the JAX package.
    ``quantize`` rounds every level to the 8-bit grid like a bgra8Unorm
    mip chain: u8 planes with ``quantize_int8`` and scale 1/255 in integer
    arithmetic (round half to even), else the f32 emulation level by level
    (plain PyTorch, as the JAX package computes both outside its kernel).
    """
    h, w = planes.shape[-2:]
    if (h >> level) == 0 or (w >> level) == 0:
        raise ValueError(f"frame dims ({h},{w}) too small for mip {level}")
    is_u8 = planes.dtype == torch.uint8
    if quantize:
        if (quantize_int8 and is_u8 and level >= 1
                and abs(scale * 255.0 - 1.0) < 1e-9):
            m = planes
            for _ in range(level):
                m = _quant_pool_level_u8(m)
            return m.to(torch.float32) * float(np.float32(1.0 / 255.0))
        planes = planes.to(torch.float32)
        if scale != 1.0:
            planes = planes * float(np.float32(scale))
        for _ in range(level):
            # round(x * 255) / 255, the division a true one (see _div).
            planes = _div(torch.round(_pool_one_level(planes) * 255.0),
                          255.0)
        return planes
    if level == 0:
        planes = planes.to(torch.float32)
        return planes * float(np.float32(scale)) if scale != 1.0 else planes
    if is_u8 and level <= 7:
        return pool_kernel.mip_pool_planes(planes.contiguous(), level, scale)
    dev = planes.device
    pr = torch.as_tensor(_pool_matrix(h, level) * np.float32(scale),
                         device=dev)
    pc = torch.as_tensor(_pool_matrix(w, level), device=dev)
    rows = torch.matmul(planes.to(torch.float32).transpose(-1, -2), pr)
    return torch.matmul(rows.transpose(-1, -2), pc)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

def rotate_cw(x):
    """The kernels' rotated output indexing (convolveFeatures.metal:53-59):
    a 90-degree clockwise rotation, (H, W, ...) -> (W, H, ...); for the
    debug maps."""
    return torch.rot90(x, k=-1, dims=(0, 1))


# ---------------------------------------------------------------------------
# 3x3 mode stencils
# ---------------------------------------------------------------------------

# The four zero-sum masks k[dy+1][dx+1] (convolveFeatures.metal:94-113).
MODE_KERNELS = np.array(
    [
        [[-1, 0, -1], [0, 4, 0], [-1, 0, -1]],     # breathing
        [[1, 0, -1], [1, 0, -1], [1, 0, -1]],      # "vertical tilt"
        [[-1, -1, -1], [0, 0, 0], [1, 1, 1]],      # "horizontal tilt"
        [[1, 0, -1], [0, 0, 0], [-1, 0, 1]],       # saddle
    ],
    dtype=np.float32,
)


def feature_stencil_plane(plane):
    """The four 3x3 mode masks on (..., H, W) planes, clamp-to-edge
    borders (the Metal sampler).  Returns f32[..., 4, H, W]."""
    h, w = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    padded = plane.to(torch.float32)[..., rows, :][..., cols]
    outs = []
    for m in range(4):
        acc = torch.zeros_like(plane, dtype=torch.float32)
        for dy in range(3):
            for dx in range(3):
                k = float(MODE_KERNELS[m, dy, dx])
                if k == 0.0:
                    continue
                acc = acc + k * padded[..., dy:dy + h, dx:dx + w]
        outs.append(acc)
    return torch.stack(outs, dim=-3)


def intensity_stencils(plane):
    """:func:`feature_stencil_plane` in the vision kernel's sums
    (vaudio/ops/vision_kernel.py:216-224): west - east, south - north,
    4 c - (corners) and (nw + se) - (ne + sw).  Returns f32[..., 4, H, W]."""
    h, w = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-1, h + 1, device=dev).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=dev).clamp(0, w - 1)
    padded = plane.to(torch.float32)[..., rows, :][..., cols]

    def tap(dy, dx):
        return padded[..., dy:dy + h, dx:dx + w]

    west = tap(0, 0) + tap(1, 0) + tap(2, 0)
    east = tap(0, 2) + tap(1, 2) + tap(2, 2)
    north = tap(0, 0) + tap(0, 1) + tap(0, 2)
    south = tap(2, 0) + tap(2, 1) + tap(2, 2)
    breathing = 4.0 * tap(1, 1) - (tap(0, 0) + tap(0, 2) + tap(2, 0)
                                   + tap(2, 2))
    saddle = (tap(0, 0) + tap(2, 2)) - (tap(0, 2) + tap(2, 0))
    return torch.stack([breathing, west - east, south - north, saddle],
                       dim=-3)


# ---------------------------------------------------------------------------
# Hue histogram
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cell_ids_unrotated(shape: Tuple[int, int], grid: int) -> np.ndarray:
    """Per-pixel cell index in image orientation from the kernel's rotated
    coordinates (convolveFeatures.metal:155-157): row = x grid // W,
    col = (H-1-y) grid // H."""
    hm, wm = shape
    y, x = np.meshgrid(np.arange(hm), np.arange(wm), indexing="ij")
    row = (x * grid) // wm
    col = ((hm - 1 - y) * grid) // hm
    return (row * grid + col).astype(np.int64)


def _cell_tile_bounds(hm: int, wm: int, grid: int):
    """Per-cell pixel rectangles in image orientation: (x_bands, y_bands),
    each a (start, length) pair per band index."""
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    xb = [(int(np.argmax(row_of_x == r)), int(np.sum(row_of_x == r)))
          for r in range(grid)]
    yb = [(int(np.argmax(col_of_y == c)), int(np.sum(col_of_y == c)))
          for c in range(grid)]
    return xb, yb


def hue_bin_factorization(bins: int):
    """``bins = f1 * f2`` with f2 the largest factor <= 16 (360 -> 24 x 15),
    or (None, None) for a prime count."""
    f2 = next((f for f in range(16, 1, -1) if bins % f == 0), None)
    return (None, None) if f2 is None else (bins // f2, f2)


def hue_histogram_planes(h, s, i, cfg: AuralizerConfig):
    """Per-cell hue histogram over gated pixels (convolveFeatures.metal
    :132-165) from (..., Hm, Wm) HSI planes: gate S > 0 and I > 0.1, bin
    floor(H * 359).  An integer scatter-add; its counts equal those of the
    JAX package's ``tiled`` method.  Returns f32[..., cells, bins]."""
    bins = cfg.num_hue_bins
    cells = cfg.num_cells
    hm, wm = h.shape[-2:]
    lead = h.shape[:-2]
    n_hist = int(np.prod(lead, dtype=np.int64)) * cells * bins

    gate = (s > cfg.saturation_gate) & (i > cfg.intensity_gate)
    bin_idx = torch.clamp((h * float(bins - 1)).to(torch.int64), 0, bins - 1)
    cell_idx = torch.as_tensor(_cell_ids_unrotated((hm, wm), cfg.grid_size),
                               device=h.device)
    frame = torch.arange(n_hist // (cells * bins), device=h.device) \
        .reshape(lead + (1, 1))
    flat = (frame * cells + cell_idx) * bins + bin_idx
    flat = torch.where(gate, flat, torch.full_like(flat, n_hist))  # drop
    hist = torch.zeros(n_hist + 1, dtype=torch.int32, device=h.device)
    hist.scatter_add_(0, flat.reshape(-1),
                      torch.ones(flat.numel(), dtype=torch.int32,
                                 device=h.device))
    return hist[:n_hist].reshape(lead + (cells, bins)).to(torch.float32)


def hist_max_and_arg(hist):
    """Per-cell (max count, argmax bin) with the LAST-maximum tie-break of
    Swift's ``max(by:)`` (VisionEngine.swift:264)."""
    bins = hist.shape[-1]
    max_val = torch.amax(hist, dim=-1)
    arg = (bins - 1 - torch.argmax(torch.flip(hist, dims=(-1,)), dim=-1)
           ).to(torch.float32)
    return max_val, arg


def update_hues_from_stats(max_val, arg, prev_hues, mixing,
                           cfg: AuralizerConfig):
    """The gated, truncating hue EMA (VisionEngine.swift:255-271) — the
    only serial piece of the vision pass.  A mixing f32[S] (a stream axis:
    hues i32[S, cells]) mixes each stream's hues with its own value, in
    the same f32 op order."""
    if mixing.dim() == 1:
        mixing = mixing[:, None]
    mixed = prev_hues.to(torch.float32) * mixing + arg * (1.0 - mixing)
    new = mixed.to(torch.int32)          # truncation, as Swift Int32(Float)
    return torch.where(max_val > float(np.float32(cfg.hist_count_gate)),
                       new, prev_hues.to(torch.int32))


def update_hues(hist, prev_hues, mixing, cfg: AuralizerConfig):
    """Per-cell dominant hue, gated and EMA-smoothed: i32[cells]."""
    max_val, arg = hist_max_and_arg(hist)
    return update_hues_from_stats(max_val, arg, prev_hues, mixing, cfg)


# ---------------------------------------------------------------------------
# Gradient statistics
# ---------------------------------------------------------------------------

def _spatial_cell_stats(modes, cfg: AuralizerConfig):
    """The clean spatial cells (cfg.linear_cell_grads=False,
    vaudio/vision/features.py:655-666): the statistics over the histogram's
    tiles, as f32 products with the pixel -> cell one-hot (TF32 is off, so
    they are full f32 products; the JAX package's sum order is not
    reproduced: rtol 1e-5), and the max as a scatter-max from 0."""
    hm, wm = modes.shape[-2:]
    lead = modes.shape[:-3]
    cells = cfg.num_cells
    dev = modes.device
    cell_idx = torch.as_tensor(
        _cell_ids_unrotated((hm, wm), cfg.grid_size).reshape(-1), device=dev)
    oh = (cell_idx[:, None] == torch.arange(cells, device=dev)).to(
        torch.float32)                                          # (p, cells)
    counts = torch.sum(oh, dim=0)
    flat = modes.reshape(lead + (4, hm * wm))
    sq = torch.matmul(flat[..., 0, :] * flat[..., 0, :], oh)
    ay = torch.matmul(torch.abs(flat[..., 1, :]), oh)
    az = torch.matmul(torch.abs(flat[..., 2, :]), oh)
    a3 = torch.abs(flat[..., 3, :])
    aw = torch.zeros(lead + (cells,), dtype=torch.float32, device=dev) \
        .scatter_reduce(-1, cell_idx.expand(a3.shape), a3, "amax")
    return torch.stack([torch.sqrt(sq / counts), ay / counts, az / counts,
                        aw], dim=-1)


def cell_gradient_stats_planes(modes, cfg: AuralizerConfig):
    """Per-cell (RMS breathing, mean|vtilt|, mean|htilt|, max|saddle|) of
    intensity mode planes f32[..., 4, Hm, Wm] (VisionEngine.swift:273-295).

    Cells are contiguous 1/16 slices of the flattened ROTATED buffer (the
    reference quirk, cfg.linear_cell_grads): column bands when Wm % 16 == 0,
    else an explicit rotation with the remainder in the last cell.  With
    ``linear_cell_grads=False`` the cells are the histogram's 4x4 spatial
    tiles (:func:`_spatial_cell_stats`).
    Returns f32[..., cells, 4].
    """
    if not cfg.linear_cell_grads:
        return _spatial_cell_stats(modes, cfg)
    hm, wm = modes.shape[-2:]
    lead = modes.shape[:-3]
    cells = cfg.num_cells
    p = hm * wm
    per = p // cells
    if wm % cells == 0:
        cw = wm // cells
        b = modes.reshape(lead + (4, hm, cells, cw))
        dims = (-3, -1)
        sq = torch.sum(b[..., 0, :, :, :] * b[..., 0, :, :, :], dim=dims)
        ay = torch.sum(torch.abs(b[..., 1, :, :, :]), dim=dims)
        az = torch.sum(torch.abs(b[..., 2, :, :, :]), dim=dims)
        aw = torch.amax(torch.abs(b[..., 3, :, :, :]), dim=dims)
        n = float(np.float32(hm * cw))
        return torch.stack([torch.sqrt(sq / n), ay / n, az / n, aw], dim=-1)
    flat = torch.rot90(modes, k=-1, dims=(-2, -1)).reshape(lead + (4, p))
    stats = []
    for c in range(cells):
        start = c * per
        end = p if c == cells - 1 else (c + 1) * per
        sl = flat[..., start:end]
        n = float(np.float32(end - start))
        stats.append(torch.stack([
            torch.sqrt(torch.sum(sl[..., 0, :] * sl[..., 0, :], dim=-1) / n),
            torch.sum(torch.abs(sl[..., 1, :]), dim=-1) / n,
            torch.sum(torch.abs(sl[..., 2, :]), dim=-1) / n,
            torch.amax(torch.abs(sl[..., 3, :]), dim=-1),
        ], dim=-1))
    return torch.stack(stats, dim=-2)


# ---------------------------------------------------------------------------
# Full vision step
# ---------------------------------------------------------------------------

def yuv420_mip_to_rgb_planes(y, u, v, cfg: AuralizerConfig,
                             studio_swing: bool = True):
    """Planar YUV 4:2:0 frames -> RGB mip planes: u8 y (..., H, W), u and v
    (..., H/2, W/2) -> f32 (..., 3, H >> l, W >> l) in [0, 1].

    The box filter commutes with the affine BT.601 transform, so Y pools
    at ``mip_level`` and the chroma at ``mip_level - 1`` first, and the
    colour conversion runs on the mips.  u8 planes at a level K1 takes
    (1..7) go through its YUV entry (:func:`ops.pool_kernel
    .mip_pool_yuv420`, one launch a dispatch; its plain version on the
    CPU): each scale folds into K1's epilogue, the offsets are separate
    adds, the chroma mips are cropped to the luma's size, and the
    conversion is separate rounded ops (never a fused multiply-add), as
    eager JAX computes it.  Other planes take the same ops after
    :func:`mip_downsample_planes`.
    """
    level = cfg.mip_level
    if level < 1:
        raise ValueError(
            f"the planar-YUV ingest path pools half-resolution chroma at "
            f"mip level-1 and so requires mip_level >= 1 (got {level}); "
            f"convert to RGB on the host (io.yuv420_to_rgb) for mip_level=0")
    if level <= 7 and all(p.dtype == torch.uint8 for p in (y, u, v)):
        return pool_kernel.mip_pool_yuv420(y.contiguous(), u.contiguous(),
                                           v.contiguous(), level,
                                           studio_swing)
    y_scale, y_off, c_scale, c_off = pool_kernel.yuv420_scales(studio_swing)
    return pool_kernel.rgb_from_yuv_mips(
        mip_downsample_planes(y, level, scale=y_scale),
        mip_downsample_planes(u, level - 1, scale=c_scale),
        mip_downsample_planes(v, level - 1, scale=c_scale), y_off, c_off)


def frame_mip_planes(frames, cfg: AuralizerConfig):
    """Frames -> f32 mip planes (T, 3, H >> l, W >> l): RGB frames
    (T, H, W, 3), u8 or f32 in [0, 1], or a dict ``{"y", "u", "v"}`` of
    planar u8 YUV 4:2:0 (T, H, W) and (T, H/2, W/2)
    (:func:`yuv420_mip_to_rgb_planes`).  u8 RGB frames go through kernel
    K1 (:func:`ops.pool_kernel.mip_pool`), the 1/255 folded into its
    epilogue, unless ``quantize_mips`` asks for the 8-bit chain."""
    if isinstance(frames, dict):
        return yuv420_mip_to_rgb_planes(frames["y"], frames["u"],
                                        frames["v"], cfg)
    level = cfg.mip_level
    if (frames.dtype == torch.uint8 and 1 <= level <= 7
            and not cfg.quantize_mips):
        return pool_kernel.mip_pool(frames, level, scale=1.0 / 255.0)
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    return mip_downsample_planes(frames.permute(0, 3, 1, 2), level,
                                 cfg.quantize_mips, scale=scale,
                                 quantize_int8=cfg.quantize_mips_int8)


def _rot_pack(modes):
    """(..., 4, hm, wm) mode planes -> the rotated (..., wm, hm, 4) pack of
    the Metal debug buffers."""
    return torch.rot90(modes, k=-1, dims=(-2, -1)).movedim(-3, -1)


def frame_stats(frames, cfg: AuralizerConfig,
                compute_debug_maps: bool = False):
    """The stateless vision pass over a chunk: frames (see
    :func:`frame_mip_planes`) -> (hist f32[T, 16, 360], grads
    f32[T, 16, 4]).  With ``cfg.use_pallas_vision`` and a mip the kernel
    takes, everything after the mip pool is kernel K3
    (:func:`ops.vision_kernel.vision_stats`), else the stages below.

    ``compute_debug_maps`` bypasses K3, as the JAX package does, and adds a
    third result, the debug dict: ``histogram``, the rotated
    (T, wm, hm, 4) mode packs ``hue_map``, ``saturation_map`` and
    ``intensity_map``, and ``mip_hsi`` (T, hm, wm, 3)."""
    mip = frame_mip_planes(frames, cfg)
    if cfg.use_pallas_vision and not compute_debug_maps:
        # Imported here: ops.vision_kernel imports this module.
        from vaudio_torch.ops import vision_kernel
        if vision_kernel.supports(mip.shape[-2], mip.shape[-1], cfg):
            return vision_kernel.vision_stats(mip.contiguous(), cfg)
    h, s, i = rgb_to_hsi_planes(mip[:, 0], mip[:, 1], mip[:, 2],
                                fast_acos=cfg.fast_hue_acos)
    hist = hue_histogram_planes(h, s, i, cfg)
    imodes = feature_stencil_plane(i)
    grads = cell_gradient_stats_planes(imodes, cfg)
    if not compute_debug_maps:
        return hist, grads
    return hist, grads, {
        "histogram": hist,
        "hue_map": _rot_pack(feature_stencil_plane(h)),
        "saturation_map": _rot_pack(feature_stencil_plane(s)),
        "intensity_map": _rot_pack(imodes),
        "mip_hsi": torch.stack([h, s, i], dim=-1),
    }


def _one_frame(frame):
    """One frame (an array, or a dict of planes) as a batch of one."""
    if isinstance(frame, dict):
        return {k: v[None] for k, v in frame.items()}
    return frame[None]


def extract_features(frame, prev_hues, mixing, cfg: AuralizerConfig,
                     compute_debug_maps: bool = False):
    """The full vision pass of one frame (H, W, 3), or a dict of its YUV
    planes -> (hues i32[16], grads f32[16, 4]); with
    ``compute_debug_maps`` also the frame's debug dict (see
    :func:`frame_stats`).  With a stream axis (prev_hues i32[S, 16],
    mixing f32[S]) ``frame`` is one frame of each of S streams, (S, H, W,
    3) or planes (S, ...), all through one :func:`frame_stats` call, and
    every result leads with S."""
    pod = prev_hues.dim() == 2
    out = frame_stats(frame if pod else _one_frame(frame), cfg,
                      compute_debug_maps)
    if not pod:
        out = tuple(o[0] for o in out[:2]) + (
            ({k: v[0] for k, v in out[2].items()},) if compute_debug_maps
            else ())
    hues = update_hues(out[0], prev_hues, mixing, cfg)
    return (hues,) + tuple(out[1:])
