"""Kernel K1: the u8 mip pool.

u8 frames (T, H, W, 3) -> f32 planes (T, 3, H >> l, W >> l): the integer
sum of each 2^l x 2^l block of (v - 128), then one f32 ``acc * gain +
offset`` with gain = scale / 4^l and offset = 128 scale; rows and columns
past the last full block are dropped.  It replaces the TPU kernel
``vaudio/ops/pool_kernel.py::mip_pool_pallas``, reading the interleaved
frames in place where the JAX package first transposes them to planes.
The CUDA source is ``csrc/pool_kernel.cu``.

:func:`mip_pool` routes by device: a CPU tensor runs :func:`mip_pool_plain`
(the u8 path of ``vision.features.mip_downsample_planes``), a CUDA tensor
the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch.ops import _build

#: Kernel launches so far (a run resets it to 0 and reads it after).
launches = 0


def _epilogue(level: int, scale: float):
    """(gain, offset) as the f32 values the JAX package folds in
    (vaudio/vision/features.py:302-303)."""
    k = 1 << level
    return float(np.float32(scale / (k * k))), float(np.float32(128.0 * scale))


def mip_pool_plain(planes, level: int, scale: float = 1.0):
    """The plain PyTorch version on u8 planes (..., H, W): exact integer
    block sums, then one f32 multiply and one add."""
    k = 1 << level
    ho, wo = planes.shape[-2] >> level, planes.shape[-1] >> level
    x = planes[..., :ho * k, :wo * k].to(torch.int32) - 128
    acc = x.reshape(x.shape[:-2] + (ho, k, wo, k)).sum(dim=(-3, -1))
    gain, offset = _epilogue(level, scale)
    return acc.to(torch.float32) * gain + offset


def mip_pool(frames, level: int, scale: float = 1.0):
    """u8 frames (T, H, W, 3) -> f32 (T, 3, H >> level, W >> level)."""
    if frames.device.type == "cpu":
        return mip_pool_plain(frames.permute(0, 3, 1, 2), level, scale)
    _build.require_cuda(frames, "mip_pool")
    global launches
    if (frames.dtype != torch.uint8 or frames.ndim != 4
            or frames.shape[-1] != 3 or not frames.is_contiguous()):
        raise ValueError(f"mip_pool: frames must be contiguous u8 "
                         f"(T, H, W, 3); got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    T, H, W, _ = frames.shape
    if not 1 <= level <= 7 or (H >> level) == 0 or (W >> level) == 0:
        raise ValueError(f"mip_pool: level {level} does not fit frames "
                         f"{H}x{W} (1 <= level <= 7)")
    out = torch.empty((T, 3, H >> level, W >> level), dtype=torch.float32,
                      device=frames.device)
    gain, offset = _epilogue(level, scale)
    err = _build.lib().vaudio_mip_pool_u8(
        frames.data_ptr(), out.data_ptr(), T, H, W, level, gain, offset,
        _build.stream_ptr(frames.device))
    _build.check(err, "mip_pool")
    launches += 1
    return out
