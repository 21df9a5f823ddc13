"""Structured u8 test clips for the PyTorch port's parity tests (RGB, and
planar YUV 4:2:0 with an RGB -> I420/NV12 converter), and the inputs of
the audio tail K4 (numpy and torch only, so the GPU-only tests and
chip_smoke.py can use it without jax)."""

import numpy as np
import torch

from vaudio_torch.dsp.core import hann_window_norm
from vaudio_torch.ops import audio_kernel


def _hue_bin_f64(r, g, b):
    """The f64 hue of convolveFeatures.metal:14-38 in bins (h * 359, whose
    floor is the bin) of RGB in [0, 1]."""
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    th = np.arccos(np.clip(num / np.where(den > 0, den, 1.0), -1.0, 1.0))
    return np.where(b <= g, th, 2 * np.pi - th) / (2 * np.pi) * 359


def _mid_bin_colors(seed: int = 1):
    """Saturated, bright u8 colours whose HSI hue lies in the middle half of
    a histogram bin (f64 formula of convolveFeatures.metal:14-38), so no
    f32 evaluation order can move them across a bin edge.
    Returns (colors u8[N, 3], bins int[N])."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (400000, 3)).astype(np.float64)
    c = c[(c.max(1) >= 160) & (c.min(1) <= 60)]
    x = _hue_bin_f64(*(c / 255.0).T)
    keep = np.abs(x - np.floor(x) - 0.5) < 0.25
    return c[keep].astype(np.uint8), np.floor(x[keep]).astype(np.int64)


_COLORS, _BINS = _mid_bin_colors()


def rgb_to_yuv420(frames, studio_swing: bool = True) -> dict:
    """u8 RGB (T, H, W, 3), H and W even -> planar YUV 4:2:0 (I420 planes)
    ``{"y": (T, H, W), "u", "v": (T, H/2, W/2)}`` u8, BT.601 (Kr 0.299,
    Kb 0.114); studio swing (Y 16-235, chroma 16-240) or full swing; each
    chroma sample from the mean of its 2x2 block, all rounded to nearest."""
    T, H, W, _ = frames.shape
    out = {k: [] for k in "yuv"}
    for f in frames:
        r, g, b = (f.astype(np.float32) / np.float32(255.0)).transpose(2, 0,
                                                                        1)
        luma = 0.299 * r + 0.587 * g + 0.114 * b
        cb = (b - luma) / 1.772
        cr = (r - luma) / 1.402
        ys, cs = (219.0, 224.0) if studio_swing else (255.0, 255.0)
        planes = {"y": (16.0 if studio_swing else 0.0) + ys * luma,
                  "u": 128.0 + cs * cb.reshape(H // 2, 2, W // 2, 2)
                  .mean(axis=(1, 3)),
                  "v": 128.0 + cs * cr.reshape(H // 2, 2, W // 2, 2)
                  .mean(axis=(1, 3))}
        for k, p in planes.items():
            out[k].append(np.clip(np.rint(p), 0, 255).astype(np.uint8))
    return {k: np.stack(v) for k, v in out.items()}


def yuv420_bytes(planes: dict, t: int, fmt: str = "i420") -> bytes:
    """Frame ``t`` of planar YUV as raw bytes: ``i420`` (Y, U, V planes) or
    ``nv12`` (Y, then U and V interleaved)."""
    y, u, v = (planes[k][t] for k in "yuv")
    if fmt == "i420":
        return y.tobytes() + u.tobytes() + v.tobytes()
    uv = np.stack([u, v], axis=-1).reshape(u.shape[0], -1)
    return y.tobytes() + uv.tobytes()


def _yuv_safe_colors():
    """The mid-bin colours whose hue, after the round trip through u8
    studio-swing YUV and the device's BT.601 conversion (f64), still lies
    in the middle half of a bin.  Returns (colors u8[N, 3], bins int[N])."""
    # One frame of 2 x 2 blocks, a colour each.
    yuv = rgb_to_yuv420(np.repeat(np.repeat(_COLORS[None, None], 2, axis=1),
                                  2, axis=2))
    y = (yuv["y"][0, 0, 0::2].astype(np.float64) - 16.0) / 219.0
    u = (yuv["u"][0, 0].astype(np.float64) - 128.0) / 224.0
    v = (yuv["v"][0, 0].astype(np.float64) - 128.0) / 224.0
    rgb = np.clip([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v,
                   y + 1.772 * u], 0.0, 1.0)
    x = _hue_bin_f64(*rgb)
    keep = ((np.abs(x - np.floor(x) - 0.5) < 0.25) & (rgb.max(0) >= 0.6)
            & (rgb.min(0) <= 0.25))
    return _COLORS[keep], np.floor(x[keep]).astype(np.int64)


_YUV_COLORS, _YUV_BINS = _yuv_safe_colors()


def _structured(seed, T, H, W, mip, grid, colors, bins) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hm, wm = H >> mip, W >> mip
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    cell = row_of_x[None, :] * grid + col_of_y[:, None]
    cell = np.repeat(np.repeat(cell, 1 << mip, 0), 1 << mip, 1)
    prev = np.zeros(grid * grid, np.int64)
    frames = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        pick = rng.integers(len(colors), size=grid * grid)
        for k in range(grid * grid):
            while (9 * prev[k] + bins[pick[k]]) % 10 == 0:
                pick[k] = rng.integers(len(colors))
            prev[k] = (9 * prev[k] + bins[pick[k]]) // 10
        frames[t, :cell.shape[0], :cell.shape[1]] = colors[pick][cell]
    return frames


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
    return _structured(seed, T, H, W, mip, grid, _COLORS, _BINS)


def structured_yuv_frames(seed: int, T: int, H: int, W: int, mip: int = 3,
                          grid: int = 4) -> dict:
    """:func:`structured_frames` as planar studio-swing YUV 4:2:0 (H, W
    multiples of 2^mip), from colours whose hue stays mid-bin through the
    YUV round trip, and with no hue-EMA tie on the hues the device's
    conversion gives (the jitted JAX pipelines may contract the BT.601
    products into FMAs, which moves the mips by an ulp)."""
    return rgb_to_yuv420(_structured(seed, T, H, W, mip, grid, _YUV_COLORS,
                                     _YUV_BINS))


def k4_edge_frames(rng) -> np.ndarray:
    """f32 stereo frames (11, 2, 4096) for the audio tail: random at three
    scales, all zero, one NaN, one +inf, one -inf, one value near FLT_MAX,
    values near 3e37, and denormal values."""
    frames = [rng.normal(size=(2, 4096)).astype(np.float32) * s
              for s in (1.0, 1e-3, 40.0)]
    frames.append(np.zeros((2, 4096), np.float32))
    for pos, v in (((0, 5), np.nan), ((1, 7), np.inf), ((0, 9), -np.inf)):
        f = rng.normal(size=(2, 4096)).astype(np.float32)
        f[pos] = v
        frames.append(f)
    big = rng.uniform(-1, 1, (2, 4096)).astype(np.float32)
    big[0, 0] = np.float32(3.4e38)
    frames.append(big)
    for scale in (3e37, 1e-39):
        frames.append(rng.uniform(-1, 1, (2, 4096)).astype(np.float32)
                      * np.float32(scale))
    return np.stack(frames)


def k4_args(rng, T: int, channels: int, nfft: int = 4096,
            device="cpu") -> list:
    """K4's arguments on ``device``: signals f32[T, (C,) nfft] whose peaks
    move from frame to frame (so the running max takes both its attack and
    its release branch), a random carried tail f32[(C,) nfft], the window,
    and (running max, attack, release) = (0.3, 0.5, 0.2)."""
    shape = (T, nfft) if channels == 1 else (T, channels, nfft)
    sig = rng.normal(size=shape).astype(np.float32)
    sig *= rng.uniform(0.01, 3.0, (T,) + (1,) * (len(shape) - 1)).astype(
        np.float32)
    tail = rng.normal(size=shape[1:]).astype(np.float32)
    return ([torch.as_tensor(x, device=device)
             for x in (sig, tail, hann_window_norm(nfft))]
            + [torch.tensor(v, dtype=torch.float32, device=device)
               for v in (0.3, 0.5, 0.2)])


def k4_stream_args(rng, S: int, T: int, channels: int, nfft: int = 4096,
                   device="cpu") -> list:
    """K4's arguments on a stream axis of S streams, each with its own
    loudness (scales 1e-3 to 1e3 across the streams), tail, running max,
    attack and release: signals f32[S, T, (C,) nfft], tails f32[S, (C,)
    nfft], the window, and running max, attack and release f32[S]."""
    per = [k4_args(rng, T, channels, nfft, device) for _ in range(S)]
    scales = np.geomspace(1e-3, 1e3, S).astype(np.float32)
    sig = torch.stack([a[0] * float(k) for a, k in zip(per, scales)])
    tail = torch.stack([a[1] for a in per])
    scalars = [torch.as_tensor(rng.uniform(lo, hi, S).astype(np.float32),
                               device=device)
               for lo, hi in ((0.05, 3.0), (0.0, 1.0), (0.0, 1.0))]
    return [sig, tail, per[0][2]] + scalars


def k4_stream_forms(order: str):
    """(wrapper, plain version, signals of the call) of K4's ``order`` on a
    stream axis: the one-frame ``agc_overlap_add`` on frame 0 of each
    stream (``"frame"``, made contiguous), or the T-frame entries."""
    if order == "frame":
        return (audio_kernel.agc_overlap_add,
                audio_kernel.agc_overlap_add_plain,
                lambda sig: sig[:, 0].contiguous())
    fn, plain, _ = k4_forms(order)
    return fn, plain, lambda sig: sig


def k4_frame_call(agc_overlap_add):
    """The one-frame K4 ``agc_overlap_add`` (pcm f32[(C,) hop]) called as
    the chunk form at T=1 (signals f32[1, (C,) nfft] -> pcm f32[1, hop(,
    C)])."""
    def call(signals, *rest):
        pcm, tail, running_max = agc_overlap_add(signals[0], *rest)
        return (pcm if pcm.ndim == 1 else pcm.T)[None], tail, running_max
    return call


def k4_chained(call, signals, tail, window, running_max, attack, release):
    """``signals`` through ``call`` (the chunk form) one frame at a time,
    the tail and the running max carried: (pcm f32[T, hop(, C)], the last
    tail, the last running max)."""
    outs = []
    for k in range(signals.shape[0]):
        pcm, tail, running_max = call(signals[k:k + 1], tail, window,
                                      running_max, attack, release)
        outs.append(pcm)
    return torch.cat(outs), tail, running_max


def k4_forms(order: str):
    """(wrapper, plain version, run) of K4's op ``order``; run(fn, *args)
    takes a chunk through fn: in one call in the chunk order and in the
    frame order at T frames (``"frames"``, ``agc_overlap_add_frames``),
    frame by frame through ``agc_overlap_add`` (as frame_step calls it) in
    the frame order (``"frame"``)."""
    if order == "chunk":
        return (audio_kernel.agc_overlap_add_chunk,
                audio_kernel.agc_overlap_add_chunk_plain,
                lambda fn, *args: fn(*args))
    if order == "frames":
        return (audio_kernel.agc_overlap_add_frames,
                audio_kernel.agc_overlap_add_frames_plain,
                lambda fn, *args: fn(*args))
    return (k4_frame_call(audio_kernel.agc_overlap_add),
            k4_frame_call(audio_kernel.agc_overlap_add_plain), k4_chained)
