"""Kernel K3 (and K3' at T = 1): the fused vision epilogue.

f32 mip planes (T, 3, hm, wm) -> (hist f32[T, cells, bins], grads f32[T,
cells, 4]): HSI with the TPU kernel's own fdlibm acosf, the gated hue
histogram over the cells' static tiles, the four clamp-to-edge intensity
stencils and the per-cell gradient statistics over the linear-slice column
bands.  It replaces the TPU kernels
``vaudio/ops/vision_kernel.py::vision_stats_pallas_batched`` and
``vision_stats_pallas``; the CUDA source is ``csrc/vision_kernel.cu``.  The
kernel's blocks each take one rectangle of :func:`block_rects`, built here
on the host and kept on the device per shape.

:func:`vision_stats` routes by device: a CPU tensor runs
:func:`vision_stats_plain` (the port's vision stages in the kernel's op
order), a CUDA tensor the kernel.  :func:`supports` is the JAX package's
gate, size bound included, so that both packages take the same numerics at
every shape; :func:`vision_stats` itself takes any mip the kernel takes
(:func:`kernel_takes`), the 4K mip included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vaudio_torch import device_constant
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.ops import _build
# The module, not its names: vision.features imports this package, so its
# names are read at call time.
from vaudio_torch.vision import features

#: Kernel launches so far (a run resets it to 0 and reads it after).
launches = 0


@functools.lru_cache(maxsize=32)
def block_rects(hm: int, wm: int, grid: int) -> np.ndarray:
    """The rectangle of each block of the kernel's grid, i32[2 cells, 4] of
    (y0, rows, x0, columns): first the cells' histogram tiles in cell order
    (the TPU kernel's static tiles, vaudio/ops/vision_kernel.py:298-304:
    cell rr * grid + cc spans x band rr and y band cc), then the cells'
    gradient bands, cw = wm / cells columns each over all rows."""
    cells = grid * grid
    xb, yb = features._cell_tile_bounds(hm, wm, grid)
    tiles = [(y0, yh, x0, xw) for x0, xw in xb for y0, yh in yb]
    cw = wm // cells
    bands = [(0, hm, c * cw, cw) for c in range(cells)]
    out = np.array(tiles + bands, dtype=np.int32)
    out.setflags(write=False)
    return out


def kernel_takes(hm: int, wm: int, cfg: AuralizerConfig) -> bool:
    """What the CUDA kernel itself takes: a factorable bin count, the
    linear-slice gradient cells (wm a multiple of the cell count) and a mip
    of at least 2 x 2, at any size."""
    f1, _ = features.hue_bin_factorization(cfg.num_hue_bins)
    if f1 is None:
        return False
    if not cfg.linear_cell_grads or wm % cfg.num_cells != 0:
        return False
    return hm >= 2 and wm >= 2


def supports(hm: int, wm: int, cfg: AuralizerConfig) -> bool:
    """The JAX package's gate (vaudio/ops/vision_kernel.py:105-123):
    :func:`kernel_takes` and the TPU kernel's VMEM bound, hm * wm * 4 * 26
    <= 10 MB (~1440p mips and below; the 4K mip, 270 x 480, is refused).
    The paths route through it, so that both packages take the same
    numerics at every shape; the card's kernel has no such bound and is
    called beyond it only directly."""
    return kernel_takes(hm, wm, cfg) and hm * wm * 4 * 26 <= (10 << 20)


def vision_stats_plain(mips, cfg: AuralizerConfig):
    """The plain PyTorch version: the port's HSI (with the fdlibm acos),
    histogram, stencil and statistics stages, in the kernel's op order."""
    h, s, i = features.rgb_to_hsi_planes(mips[:, 0], mips[:, 1],
                                         mips[:, 2],
                                         acos=features.acos_fdlibm)
    hist = features.hue_histogram_planes(h, s, i, cfg)
    grads = features.cell_gradient_stats_planes(
        features.intensity_stencils(i), cfg)
    return hist, grads


def vision_stats(mips, cfg: AuralizerConfig):
    """f32 mips (T, 3, hm, wm) -> (hist f32[T, cells, bins], grads f32[T,
    cells, 4]); T = 1 is the per-frame form (K3')."""
    if mips.device.type == "cpu":
        return vision_stats_plain(mips, cfg)
    _build.require_cuda(mips, "vision_stats")
    global launches
    if (mips.dtype != torch.float32 or mips.ndim != 4 or mips.shape[1] != 3
            or not mips.is_contiguous()):
        raise ValueError(f"vision_stats: mips must be contiguous f32 "
                         f"(T, 3, hm, wm); got {mips.dtype} "
                         f"{tuple(mips.shape)}")
    T, _, hm, wm = mips.shape
    if not kernel_takes(hm, wm, cfg):
        raise ValueError(f"vision_stats: the kernel does not take a "
                         f"{hm}x{wm} mip with this config (see "
                         f"kernel_takes)")
    cells, bins = cfg.num_cells, cfg.num_hue_bins
    if bins * 4 > 227 * 1024:
        raise ValueError(f"vision_stats: a histogram of {bins} bins does "
                         f"not fit one block's shared memory")
    rects = device_constant(("k3_rects", hm, wm, cfg.grid_size),
                            lambda: block_rects(hm, wm, cfg.grid_size).copy(),
                            mips.device)
    hist = torch.empty((T, cells, bins), dtype=torch.float32,
                       device=mips.device)
    grads = torch.empty((T, cells, 4), dtype=torch.float32,
                        device=mips.device)
    err = _build.lib().vaudio_vision_stats(
        mips.data_ptr(), rects.data_ptr(), hist.data_ptr(), grads.data_ptr(),
        T, hm, wm, cells, bins, float(np.float32(cfg.saturation_gate)),
        float(np.float32(cfg.intensity_gate)), _build.stream_ptr(mips.device))
    _build.check(err, "vision_stats")
    launches += 1
    return hist, grads
