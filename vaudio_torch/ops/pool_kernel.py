"""Kernel K1: the u8 mip pool.

u8 frames (T, H, W, 3) -> f32 planes (T, 3, H >> l, W >> l): the integer
sum of each 2^l x 2^l block of (v - 128), then one f32 ``acc * gain +
offset`` with gain = scale / 4^l and offset = 128 scale; rows and columns
past the last full block are dropped.  It replaces the TPU kernel
``vaudio/ops/pool_kernel.py::mip_pool_pallas``, reading the interleaved
frames in place where the JAX package first transposes them to planes.
Three entries share the kernel's band loads (``csrc/pool_kernel.cu``):

* :func:`mip_pool`, interleaved RGB frames;
* :func:`mip_pool_planes`, the TPU kernel's own form (u8 planes
  (..., H, W)), for ``vision.features.mip_downsample_planes``;
* :func:`mip_pool_yuv420`, one planar YUV 4:2:0 dispatch straight to the
  clamped RGB mips in one launch: what ``vision.features
  .yuv420_mip_to_rgb_planes`` computes, the pools, the offsets, the chroma
  crop and BT.601, without the intermediates in device memory.

Each entry routes by device: a CPU tensor runs its plain version
(:func:`mip_pool_plain`, :func:`mip_pool_yuv420_plain`), a CUDA tensor the
kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vaudio_torch.ops import _build

#: Kernel launches so far (a run resets them to 0 and reads them after):
#: of the interleaved entry, the planar entry and the YUV entry.
launches = 0
planar_launches = 0
yuv_launches = 0

#: The BT.601 factors of R = Y + kr V, G = Y - kgu U - kgv V, B = Y + kb U,
#: as the f32 values eager JAX multiplies by.
BT601 = tuple(float(np.float32(c)) for c in (1.402, 0.344136, 0.714136,
                                              1.772))


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
    _check_grid("mip_pool", T)
    out = torch.empty((T, 3, H >> level, W >> level), dtype=torch.float32,
                      device=frames.device)
    gain, offset = _epilogue(level, scale)
    err = _build.lib().vaudio_mip_pool_u8(
        frames.data_ptr(), out.data_ptr(), T, H, W, level, gain, offset,
        _build.stream_ptr(frames.device))
    _build.check(err, "mip_pool")
    launches += 1
    return out


#: The entries of :func:`launch_plan`, in the C interface's numbering.
ENTRIES = ("rgb", "planes", "yuv420")


def launch_plan(entry: str, T: int, H: int, W: int, level: int) -> dict:
    """The launch K1's ``entry`` (:data:`ENTRIES`) takes on the card for T
    frames (or planes) of H x W at ``level``: ``tile`` (output texels of a
    column tile), ``tiles`` (tiles a row), ``smem`` (a block's shared
    memory, bytes) and ``threads`` (a block's).  Rows are cut into tiles
    where a row's band would pass 64 KB of shared memory (every 4K RGB
    launch at mip 3) or where the launch would have fewer than 4 blocks an
    SM.  Needs the card (the plan reads its SM count)."""
    plan = (ctypes.c_int * 4)()
    err = _build.lib().vaudio_mip_pool_plan(ENTRIES.index(entry), T, H, W,
                                            level, ctypes.addressof(plan))
    _build.check(err, "launch_plan")
    return dict(zip(("tile", "tiles", "smem", "threads"), plan))


def _check_level(what: str, level: int, H: int, W: int) -> None:
    if not 1 <= level <= 7 or (H >> level) == 0 or (W >> level) == 0:
        raise ValueError(f"{what}: level {level} does not fit {H}x{W} "
                         f"(1 <= level <= 7)")


def _check_grid(what: str, z: int) -> None:
    if z > 65535:
        raise ValueError(f"{what}: {z} planes or frames exceed one launch's "
                         f"grid (65535)")


def _check_planes(what: str, planes, *others) -> None:
    for x in (planes,) + others:
        if (x.dtype != torch.uint8 or x.ndim < 2 or not x.is_contiguous()
                or x.shape[:-2] != planes.shape[:-2]
                or x.device != planes.device):
            raise ValueError(f"{what}: planes must be contiguous u8 "
                             f"(..., H, W) with one leading shape and "
                             f"device; got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


def mip_pool_planes(planes, level: int, scale: float = 1.0):
    """u8 planes (..., H, W) -> f32 (..., H >> level, W >> level)."""
    if planes.device.type == "cpu":
        return mip_pool_plain(planes, level, scale)
    _build.require_cuda(planes, "mip_pool_planes")
    global planar_launches
    _check_planes("mip_pool_planes", planes)
    H, W = planes.shape[-2:]
    _check_level("mip_pool_planes", level, H, W)
    N = planes.numel() // (H * W)
    _check_grid("mip_pool_planes", N)
    out = torch.empty(planes.shape[:-2] + (H >> level, W >> level),
                      dtype=torch.float32, device=planes.device)
    gain, offset = _epilogue(level, scale)
    err = _build.lib().vaudio_mip_pool_planes_u8(
        planes.data_ptr(), out.data_ptr(), N, H, W, level, gain, offset,
        _build.stream_ptr(planes.device))
    _build.check(err, "mip_pool_planes")
    planar_launches += 1
    return out


# ---------------------------------------------------------------------------
# Planar YUV 4:2:0 -> RGB mips
# ---------------------------------------------------------------------------

def yuv420_scales(studio_swing: bool = True):
    """(y_scale, y_off, c_scale, c_off) of BT.601 studio or full swing
    (vaudio/vision/features.py:700-705), the offsets as f32 values."""
    if studio_swing:
        y_scale, y_off = 1.0 / 219.0, -16.0 / 219.0
        c_scale, c_off = 1.0 / 224.0, -128.0 / 224.0
    else:
        y_scale, y_off = 1.0 / 255.0, 0.0
        c_scale, c_off = 1.0 / 255.0, -128.0 / 255.0
    return (y_scale, float(np.float32(y_off)), c_scale,
            float(np.float32(c_off)))


def rgb_from_yuv_mips(my, mu, mv, y_off: float, c_off: float):
    """The conversion on the mips as eager JAX computes it
    (vaudio/vision/features.py:706-715): the offsets as separate adds, the
    chroma mips cropped to the luma's size, BT.601 as separate rounded
    products and sums (never a fused multiply-add), the clamp to [0, 1].
    f32 (..., hm, wm) and chroma (..., >= hm, >= wm) -> (..., 3, hm, wm)."""
    my = my + y_off
    hm, wm = my.shape[-2:]
    mu = mu[..., :hm, :wm] + c_off
    mv = mv[..., :hm, :wm] + c_off
    kr, kgu, kgv, kb = BT601
    r = my + kr * mv
    g = my - kgu * mu - kgv * mv
    b = my + kb * mu
    return torch.clamp(torch.stack([r, g, b], dim=-3), 0.0, 1.0)


def mip_pool_yuv420_plain(y, u, v, level: int, studio_swing: bool = True):
    """The plain PyTorch version of :func:`mip_pool_yuv420`: Y pooled at
    ``level``, U and V at ``level - 1`` (at 0 not pooled: ``v * scale``,
    the JAX package's form, not the epilogue's), then
    :func:`rgb_from_yuv_mips`."""
    y_scale, y_off, c_scale, c_off = yuv420_scales(studio_swing)
    if level > 1:
        mu, mv = (mip_pool_plain(p, level - 1, c_scale) for p in (u, v))
    else:
        mu, mv = (p.to(torch.float32) * float(np.float32(c_scale))
                  for p in (u, v))
    return rgb_from_yuv_mips(mip_pool_plain(y, level, y_scale), mu, mv,
                             y_off, c_off)


def mip_pool_yuv420(y, u, v, level: int, studio_swing: bool = True):
    """One planar YUV 4:2:0 dispatch -> RGB mips in one launch: u8 y
    (..., H, W), u and v (..., Hc, Wc) with (Hc >> (level - 1),
    Wc >> (level - 1)) at least (H >> level, W >> level) -> f32
    (..., 3, H >> level, W >> level) in [0, 1], 1 <= level <= 7; equal bit
    for bit to :func:`mip_pool_yuv420_plain`."""
    if y.device.type == "cpu":
        return mip_pool_yuv420_plain(y, u, v, level, studio_swing)
    _build.require_cuda(y, "mip_pool_yuv420")
    global yuv_launches
    _check_planes("mip_pool_yuv420", y, u, v)
    H, W = y.shape[-2:]
    Hc, Wc = u.shape[-2:]
    _check_level("mip_pool_yuv420", level, H, W)
    hm, wm = H >> level, W >> level
    if (v.shape != u.shape or (Hc >> (level - 1)) < hm
            or (Wc >> (level - 1)) < wm):
        raise ValueError(f"mip_pool_yuv420: chroma planes {tuple(u.shape)} "
                         f"and {tuple(v.shape)} do not cover the luma's mip "
                         f"{hm}x{wm} at level {level - 1}")
    T = y.numel() // (H * W)
    _check_grid("mip_pool_yuv420", T)
    out = torch.empty(y.shape[:-2] + (3, hm, wm), dtype=torch.float32,
                      device=y.device)
    y_scale, y_off, c_scale, c_off = yuv420_scales(studio_swing)
    err = _build.lib().vaudio_mip_pool_yuv420_u8(
        y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), T, H, W,
        Hc, Wc, level, *_epilogue(level, y_scale), y_off,
        *_epilogue(level - 1, c_scale), c_off, *BT601,
        _build.stream_ptr(y.device))
    _build.check(err, "mip_pool_yuv420")
    yuv_launches += 1
    return out
