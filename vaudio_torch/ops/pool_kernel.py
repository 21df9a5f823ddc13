"""Kernel K1: the u8 mip pool.

u8 frames (T, H, W, 3) -> f32 planes (T, 3, H >> l, W >> l): the integer
sum of each 2^l x 2^l block of (v - 128), then one f32 ``acc * gain +
offset`` with gain = scale / 4^l and offset = 128 scale; rows and columns
past the last full block are dropped.  It replaces the TPU kernel
``vaudio/ops/pool_kernel.py::mip_pool_pallas``, reading the interleaved
frames in place where the JAX package first transposes them to planes.
:func:`mip_pool_planes` is the same kernel's planar entry, the TPU kernel's
own form (u8 planes (..., H, W)), which serves planar YUV frames.  The CUDA
source is ``csrc/pool_kernel.cu``.

Both entries route by device: a CPU tensor runs :func:`mip_pool_plain`
(the u8 path of ``vision.features.mip_downsample_planes``), a CUDA tensor
the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch.ops import _build

#: Kernel launches so far (a run resets it to 0 and reads it after): of
#: the interleaved entry, and of the planar entry.
launches = 0
planar_launches = 0


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
    _check_level("mip_pool", level, H, W)
    out = torch.empty((T, 3, H >> level, W >> level), dtype=torch.float32,
                      device=frames.device)
    gain, offset = _epilogue(level, scale)
    err = _build.lib().vaudio_mip_pool_u8(
        frames.data_ptr(), out.data_ptr(), T, H, W, level, gain, offset,
        _build.stream_ptr(frames.device))
    _build.check(err, "mip_pool")
    launches += 1
    return out


def _check_level(what: str, level: int, H: int, W: int) -> None:
    if not 1 <= level <= 7 or (H >> level) == 0 or (W >> level) == 0:
        raise ValueError(f"{what}: level {level} does not fit {H}x{W} "
                         f"(1 <= level <= 7)")


def mip_pool_planes(planes, level: int, scale: float = 1.0, second=None):
    """u8 planes (..., H, W) -> f32 (..., H >> level, W >> level).  With
    ``second`` (u8 planes of the same shape, e.g. a YUV frame's V beside
    its U) both batches go through one launch and a pair is returned."""
    if planes.device.type == "cpu":
        out = mip_pool_plain(planes, level, scale)
        return out if second is None else (
            out, mip_pool_plain(second, level, scale))
    _build.require_cuda(planes, "mip_pool_planes")
    global planar_launches
    for x in (planes,) if second is None else (planes, second):
        if (x.dtype != torch.uint8 or x.ndim < 2 or not x.is_contiguous()
                or x.shape != planes.shape or x.device != planes.device):
            raise ValueError(f"mip_pool_planes: planes must be contiguous "
                             f"u8 (..., H, W) of one shape and device; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    H, W = planes.shape[-2:]
    _check_level("mip_pool_planes", level, H, W)
    N = planes.numel() // (H * W)
    if N * (1 if second is None else 2) > 65535:
        raise ValueError(f"mip_pool_planes: {N} planes exceed one launch's "
                         f"grid (65535 with one batch, 32767 with two)")
    shape = planes.shape[:-2] + (H >> level, W >> level)
    out = torch.empty(shape, dtype=torch.float32, device=planes.device)
    out_b = None if second is None else torch.empty_like(out)
    gain, offset = _epilogue(level, scale)
    err = _build.lib().vaudio_mip_pool_planes_u8(
        planes.data_ptr(), None if second is None else second.data_ptr(),
        out.data_ptr(), None if out_b is None else out_b.data_ptr(), N, H,
        W, level, gain, offset, _build.stream_ptr(planes.device))
    _build.check(err, "mip_pool_planes")
    planar_launches += 1
    return out if second is None else (out, out_b)
