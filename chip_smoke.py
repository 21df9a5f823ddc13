#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vaudio_torch``) on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the CUDA kernels from ``vaudio_torch/csrc`` (one ``nvcc`` per
   source, all at once, into ``build/vaudio_torch/``);
3. K1, the u8 mip pool, against its plain PyTorch version on
   u8 [8, 1080, 1920, 3] frames at mip 3: integer block sums exact, f32
   within 1 ulp; both times from CUDA events;
4. K2, the Hann-peak contraction, against its plain version at T=64,
   F=2047, NP=496, K=2 and 4, at T=8, K=4 (the chunked live path's) and K2'
   at T=1: within 1e-5; frames 0, T/2 and T-1 of the T=64 call equal to
   T=1 calls on the same inputs and two calls equal, bit for bit; both
   times;
5. the offline path: ``Auralizer(config=AuralizerConfig(sample_rate=48000.0,
   channels=2), device="cuda").sonify`` on 64 structured u8 1080p frames,
   with the kernels' launch counts reset before and read after; then the
   same clip cropped to 256x256 through the port on the card and on the CPU
   (equal hue sequences, PCM within 1e-4);
6. K3, the vision epilogue, against its plain version on the mips of
   structured 1080p frames (135 x 240) at T=64, 8 and 1: counts exact,
   statistics within atol 1e-6, rtol 1e-5; the same bit checks as K2 (T=1
   against the batch, two calls); both times;
7. K4, AGC + overlap-add, mono and stereo 4096 samples: within 1e-6;
   both times;
8. the live path: ``Auralizer(source=frames, config=..., device="cuda")
   .run_until_exhausted()`` on 64 structured 1080p frames with
   ``use_pallas`` and ``use_pallas_vision``, per frame and in chunks of 8,
   the counts reset before each run and read after it (K1-K4 per frame,
   K1-K3 in chunks); the pulled PCM equal to ``run_offline`` on the card;
   a 256x256 crop through the same configuration on the card and on the
   CPU (equal hues, PCM within 1e-4);
9. a profile of the live path under torch.profiler: device events per
   frame by kind, host-to-device copies per dispatch, the device's busy
   share of the wall clock;
10. a real-time stream: 90 frames paced at 30 fps, its latency p50 / p99
    and achieved fps.

Each kernel's line gives two times: from CUDA events around a loop of calls
(``ms``; for a small kernel the host's launch overhead sets it) and the
sum of its device events under torch.profiler (``device_ms``).

The last lines are the card's name and power limit, a JSON line of the
kernels, and ``{"ok": true, "device": {...}}``.  There is no fallback to the
CPU: without a card the script fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

MIP = 3
CHUNK_T = 64                     # the offline path's chunk (run_offline_batched)
LIVE_T = 64                      # frames of each live run
LIVE_CHUNK = 8                   # the chunked live run's chunk_frames
REALTIME_T = 90                  # frames of the paced real-time run
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, and f32 outside the tensor cores (the kernels' operations are
# CUDA-core f32 and integer work).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per peak evaluation of K2: the distance (2) and
# hann_sinc_peak_fast (rint, the reduced fraction, the 5-term polynomial,
# the parity sign, the factored numerator and denominator, one divide, the
# limits: 25); K2 adds 2 per output column (a multiply-add).
K2_PEAK_OPS = 27
# Operations per mip pixel of K3, counted from csrc/vision_kernel.cu: HSI and
# gate ~20, the acos ~15, the bin and cell ~12, the stencils with the
# rolling intensity row ~27, the statistics 8, the histogram add 1 (~83;
# 90 with the loop and index arithmetic).
K3_PIXEL_OPS = 90


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` in ms, from CUDA events around a loop
    of ``reps`` calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps: int):
    """The device events (kernels and copies) of ``reps`` calls of ``fn``
    under torch.profiler, after a warm-up: a list of (name, µs)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the sum of its kernels' and
    copies' durations from torch.profiler (no host gaps), over ``reps``.
    The profiler can lose device records but never adds any (one run read
    K2 at a third of its event time), so the largest of ``tries`` is
    kept."""
    return max(sum(us for _, us in device_events(fn, reps))
               for _ in range(tries)) / reps / 1e3


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, err, fn, plain_fn, nbytes, ops,
          path, library_ms=None) -> dict:
    """A kernel's line: ``ms`` / ``plain_ms`` from CUDA events around a
    loop of calls (host launch gaps included), ``device_ms`` /
    ``plain_device_ms`` from the profiler (device work only)."""
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain_fn), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                device_ms=device_ms(fn), plain_device_ms=device_ms(plain_fn),
                path=path)


def timing(e: dict) -> str:
    return (f"kernel {e['ms']:.4f} ms ({e['device_ms']:.4f} on the device), "
            f"plain {e['plain_ms']:.4f} ms ({e['plain_device_ms']:.4f}), "
            f"bound {e['bound_ms']:.6f} ms ({e['bound_by']})")


def bits_equal(a, b) -> bool:
    """Equal bit for bit (+0 and -0 apart, NaN equal to itself)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_batch_independent(name: str, fn, inputs, T: int) -> None:
    """Fail unless two calls of ``fn`` on the T-frame ``inputs`` give the
    same bits, and frames 0, T/2 and T-1 of that call the same bits as a
    call on the frame alone."""
    full = fn(*inputs)
    again = fn(*inputs)
    if not all(bits_equal(a, b) for a, b in zip(full, again)):
        fail(f"{name} T={T}: two calls on the same inputs differ")
    for j in (0, T // 2, T - 1):
        one = fn(*(x[j:j + 1].contiguous() for x in inputs))
        if not all(bits_equal(a[j:j + 1], b) for a, b in zip(full, one)):
            fail(f"{name}: frame {j} of the T={T} call differs from the "
                 f"T=1 call on the same inputs")


def kernel_modules() -> dict:
    from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                                  vision_kernel)
    return {"mip_pool_u8": pool_kernel,
            "hann_peak_weighted_sum": spectrum_kernel,
            "vision_stats": vision_kernel,
            "agc_overlap_add": audio_kernel}


def reset_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def structured_frames(seed: int, T: int, H: int, W: int,
                      grid: int = 4) -> np.ndarray:
    """u8 frames (T, H, W, 3): each of the 16 cells one saturated, bright
    colour per frame whose hue lies mid-bin, so every cell passes the
    histogram gate and the hues move.  Each colour is picked so that the
    0.9/0.1 hue EMA never lands on an exact integer (where the truncation
    would hang on the last ulp)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (400000, 3)).astype(np.float64)
    c = c[(c.max(1) >= 160) & (c.min(1) <= 60)]
    r, g, b = (c / 255.0).T
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    th = np.arccos(np.clip(num / den, -1.0, 1.0))
    x = np.where(b <= g, th, 2 * np.pi - th) / (2 * np.pi) * 359
    keep = np.abs(x - np.floor(x) - 0.5) < 0.25
    colors, bins = c[keep].astype(np.uint8), np.floor(x[keep]).astype(int)

    hm, wm = H >> MIP, W >> MIP
    row_of_x = (np.arange(wm) * grid) // wm
    col_of_y = ((hm - 1 - np.arange(hm)) * grid) // hm
    cell = row_of_x[None, :] * grid + col_of_y[:, None]
    cell = np.repeat(np.repeat(cell, 1 << MIP, 0), 1 << MIP, 1)
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


def live_config():
    from vaudio_torch.config import AuralizerConfig
    return AuralizerConfig(sample_rate=48000.0, channels=2, use_pallas=True,
                           use_pallas_vision=True,
                           ring_buffer_frames=LIVE_T + 8)


def phase_env() -> str:
    from vaudio_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc[-1]} | {smi}")
    return smi


def phase_build(smi: str) -> None:
    from vaudio_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log = (path.parent / "nvcc.log").read_text().splitlines()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log if "Used" in ln]
    say(f"build: {time.perf_counter() - t0:.2f} s ({smi}) -> {path} | "
        + " ; ".join(regs))


def phase_k1(smi: str) -> dict:
    from vaudio_torch.ops import pool_kernel as pk
    T, H, W = LIVE_CHUNK, 1080, 1920
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (T, H, W, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    planes = frames.permute(0, 3, 1, 2)
    # scale = 4^l makes gain 1: the outputs ARE the integer block sums.
    k2 = float(4 ** MIP)
    sums = pk.mip_pool(frames, MIP, scale=k2)
    sums_plain = pk.mip_pool_plain(planes, MIP, scale=k2)
    if not torch.equal(sums, sums_plain):
        fail("K1 integer block sums differ from the plain version")
    got = pk.mip_pool(frames, MIP, scale=1.0 / 255.0)
    ref = pk.mip_pool_plain(planes, MIP, scale=1.0 / 255.0)
    torch.cuda.synchronize()
    if got.shape != (T, 3, H >> MIP, W >> MIP):
        fail(f"K1 output shape {tuple(got.shape)}")
    ulps = int((got.view(torch.int32) - ref.view(torch.int32)).abs().max())
    err = float((got - ref).abs().max())
    if ulps > 1:
        fail(f"K1 differs from the plain version by {ulps} ulp")
    out_n = T * 3 * (H >> MIP) * (W >> MIP)
    e = entry("mip_pool_u8", "vaudio_torch/csrc/pool_kernel.cu",
              "vaudio/ops/pool_kernel.py:130", err,
              lambda: pk.mip_pool(frames, MIP, scale=1.0 / 255.0),
              lambda: pk.mip_pool_plain(planes, MIP, 1.0 / 255.0),
              nbytes=T * H * W * 3 + 4 * out_n,
              ops=T * H * W * 3 + 2 * out_n, path="live_chunk")
    say(f"K1 mip_pool u8 [{T},{H},{W},3] mip {MIP}: sums exact, "
        f"max {ulps} ulp, max_abs_err {err:.3e}; {timing(e)} ({smi})")
    return e


def phase_k2(smi: str) -> list:
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.ops import spectrum_kernel as sk
    cfg = AuralizerConfig(sample_rate=48000.0)
    rng = np.random.default_rng(0)
    NP, F = 496, cfg.num_bins
    freqs = torch.as_tensor(cfg.bin_frequencies(), device="cuda")
    entries = []
    for T, K in ((CHUNK_T, 2), (CHUNK_T, 4), (LIVE_CHUNK, 4), (1, 4)):
        pf = torch.as_tensor(rng.uniform(20, 20000, (T, NP)).astype(
            np.float32), device="cuda")
        scale = torch.as_tensor((rng.choice([1.0, 0.2], (T, NP))
                                 / cfg.bin_width).astype(np.float32),
                                device="cuda")
        w = torch.as_tensor(rng.normal(0, 0.1, (T, NP, K)).astype(
            np.float32), device="cuda")
        got = sk.hann_peak_weighted_sum(freqs, pf, scale, w)
        ref = sk.hann_peak_weighted_sum_plain(freqs, pf, scale, w)
        torch.cuda.synchronize()
        if got.shape != (T, F, K):
            fail(f"K2 output shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            fail(f"K2 T={T} K={K} differs from the plain version by "
                 f"{err:.3e}")
        bits = ""
        if T == CHUNK_T:
            check_batch_independent(
                f"K2 K={K}", lambda *a: (sk.hann_peak_weighted_sum(
                    freqs, *a),), (pf, scale, w), T)
            bits = "; frames 0, T/2, T-1 equal to T=1 calls and two calls "
            bits += "equal, bit for bit"
        e = entry("hann_peak_weighted_sum" + ("" if T == CHUNK_T
                                              else f"_t{T}"),
                  "vaudio_torch/csrc/spectrum_kernel.cu",
                  "vaudio/ops/spectrum_kernel.py:"
                  + ("71" if T == 1 else "142"), err,
                  lambda: sk.hann_peak_weighted_sum(freqs, pf, scale, w),
                  lambda: sk.hann_peak_weighted_sum_plain(freqs, pf, scale,
                                                          w),
                  nbytes=4 * (F + T * NP * (2 + K) + T * F * K),
                  ops=T * F * NP * (K2_PEAK_OPS + 2 * K),
                  path={1: "live_frame", LIVE_CHUNK: "live_chunk"}.get(
                      T, "offline"))
        say(f"K2 hann_peak_weighted_sum T={T} F={F} NP={NP} K={K}: "
            f"max_abs_err {err:.3e}{bits}; {timing(e)} ({smi})")
        if K == 4:              # the stereo paths' shape
            entries.append(e)
    return entries


def phase_offline(frames: np.ndarray, smi: str) -> dict:
    from vaudio_torch.api import Auralizer
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.runtime.chunked import run_offline_batched
    cfg = AuralizerConfig(sample_rate=48000.0, channels=2)
    T = len(frames)
    aur = Auralizer(config=cfg, device="cuda")
    aur.sonify(frames[:8])                          # warm-up (cuFFT plans)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    audio = aur.sonify(frames)                      # returns host numpy
    wall = time.perf_counter() - t0
    launches = read_counts()
    if audio.shape != (T * cfg.hop_size, 2):
        fail(f"offline PCM shape {audio.shape}")
    if not np.all(np.isfinite(audio)) or not np.any(audio != 0):
        fail("offline PCM is not finite or all zero")
    if min(launches["mip_pool_u8"], launches["hann_peak_weighted_sum"]) < 1:
        fail(f"a kernel of the offline path never launched: {launches}")
    t1 = time.perf_counter()
    dev_frames = torch.as_tensor(frames, device="cuda")   # pageable copy
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t1
    say(f"offline: host-to-device copy of {T} frames from pageable memory: "
        f"{frames.nbytes / 1e6:.1f} MB in {1e3 * h2d:.2f} ms, "
        f"{frames.nbytes / h2d / 1e9:.2f} GB/s ({smi})")
    t1 = time.perf_counter()
    aur.sonify(dev_frames)
    wall_dev = time.perf_counter() - t1
    say(f"offline: Auralizer.sonify {T} frames 1080x1920 stereo 48 kHz "
        f"chunk {CHUNK_T}: {1e3 * wall / T:.3f} ms/frame from host frames, "
        f"{1e3 * wall_dev / T:.3f} ms/frame from device frames "
        f"({smi}); launches {launches}")

    crop = np.ascontiguousarray(frames[:, :256, :256])
    a_gpu, _, d_gpu = run_offline_batched(crop, cfg, debug=True,
                                          device="cuda")
    a_cpu, _, d_cpu = run_offline_batched(crop, cfg, debug=True,
                                          device="cpu")
    hues_gpu, hues_cpu = d_gpu["hues"].cpu(), d_cpu["hues"]
    if not torch.equal(hues_gpu, hues_cpu):
        fail("256x256 crop: hue sequences differ between card and CPU")
    if len(torch.unique(hues_cpu)) < 10:
        fail("256x256 crop: the hues did not move")
    err = float((a_gpu.cpu() - a_cpu).abs().max())
    if not err <= 1e-4:
        fail(f"256x256 crop: PCM card vs CPU differs by {err:.3e}")
    say(f"offline: 256x256 crop card vs CPU: hues equal "
        f"({len(torch.unique(hues_cpu))} distinct), PCM max diff {err:.3e}")
    return launches


def phase_k3(frames: np.ndarray, smi: str) -> list:
    from vaudio_torch.ops import pool_kernel
    from vaudio_torch.ops import vision_kernel as vk
    cfg = live_config()
    mips = pool_kernel.mip_pool(torch.as_tensor(frames[:CHUNK_T],
                                                device="cuda"),
                                MIP, scale=1.0 / 255.0)
    entries = []
    for T in (CHUNK_T, LIVE_CHUNK, 1):
        m = mips[:T].contiguous()
        hist, grads = vk.vision_stats(m, cfg)
        ref_h, ref_g = vk.vision_stats_plain(m, cfg)
        torch.cuda.synchronize()
        hm, wm = m.shape[-2:]
        if hist.shape != (T, 16, 360) or grads.shape != (T, 16, 4):
            fail(f"K3 output shapes {tuple(hist.shape)} {tuple(grads.shape)}")
        if not torch.equal(hist, ref_h):
            moved = float((hist - ref_h).abs().sum())
            kept = torch.equal(hist.sum(-1), ref_h.sum(-1))
            fail(f"K3 T={T} histogram differs from the plain version: L1 "
                 f"{moved}, counts per cell conserved: {kept}")
        if float(hist.sum()) <= 0:
            fail("K3 histogram is empty")
        if not torch.allclose(grads, ref_g, rtol=1e-5, atol=1e-6):
            fail(f"K3 T={T} statistics differ from the plain version by "
                 f"{float((grads - ref_g).abs().max()):.3e}")
        err = float((grads - ref_g).abs().max())
        bits = ""
        if T == CHUNK_T:
            check_batch_independent(
                "K3", lambda x: vk.vision_stats(x, cfg), (m,), T)
            bits = "; frames 0, T/2, T-1 equal to T=1 calls and two calls "
            bits += "equal, bit for bit"
        e = entry("vision_stats" + ("_t1" if T == 1 else ""),
                  "vaudio_torch/csrc/vision_kernel.cu",
                  "vaudio/ops/vision_kernel.py:"
                  + ("313" if T == 1 else "352"), err,
                  lambda: vk.vision_stats(m, cfg),
                  lambda: vk.vision_stats_plain(m, cfg),
                  nbytes=4 * T * (3 * hm * wm + 16 * (360 + 4)),
                  ops=T * hm * wm * K3_PIXEL_OPS,
                  path="live_frame" if T == 1 else "live_chunk")
        say(f"K3 vision_stats T={T} mip {hm}x{wm}: counts exact, "
            f"statistics max_abs_err {err:.3e}{bits}; {timing(e)} ({smi})")
        if T != CHUNK_T:         # the live paths' shapes
            entries.append(e)
    return entries


def phase_k4(smi: str) -> dict:
    from vaudio_torch.dsp.core import hann_window_norm
    from vaudio_torch.ops import audio_kernel as ak
    rng = np.random.default_rng(0)
    nfft, e = 4096, None
    window = torch.as_tensor(hann_window_norm(nfft), device="cuda")
    scal = [torch.tensor(v, dtype=torch.float32, device="cuda")
            for v in (0.3, 0.5, 0.2)]
    for C in (1, 2):
        shape = (nfft,) if C == 1 else (C, nfft)
        sig, tail = (torch.as_tensor(rng.normal(size=shape).astype(
            np.float32), device="cuda") for _ in range(2))
        got = ak.agc_overlap_add(sig, tail, window, *scal)
        ref = ak.agc_overlap_add_plain(sig, tail, window, *scal)
        torch.cuda.synchronize()
        if got[0].shape != shape[:-1] + (nfft // 2,):
            fail(f"K4 pcm shape {tuple(got[0].shape)}")
        err = max(float((g - r).abs().max()) for g, r in zip(got[:2],
                                                             ref[:2]))
        rel = abs(float(got[2]) - float(ref[2])) / abs(float(ref[2]))
        if not err <= 1e-6 or not rel <= 1e-6:
            fail(f"K4 C={C} differs from the plain version: {err:.3e} "
                 f"(running max rel {rel:.3e})")
        hop = nfft // 2
        e = entry("agc_overlap_add", "vaudio_torch/csrc/audio_kernel.cu",
                  "vaudio/ops/audio_kernel.py:70", err,
                  lambda: ak.agc_overlap_add(sig, tail, window, *scal),
                  lambda: ak.agc_overlap_add_plain(sig, tail, window, *scal),
                  nbytes=4 * (C * nfft + C * hop + nfft + 3 + C * hop
                              + C * nfft + 1),
                  ops=C * nfft * 9 + C * hop, path="live_frame")
        say(f"K4 agc_overlap_add C={C} nfft={nfft}: max_abs_err {err:.3e}, "
            f"running max rel {rel:.1e}; {timing(e)} ({smi})")
    return e                     # stereo: the live path's shape


def phase_live(frames: np.ndarray, smi: str) -> dict:
    from vaudio_torch.api import Auralizer
    from vaudio_torch.runtime import chunked, step
    cfg = live_config()
    clip = frames[:LIVE_T]
    for chunk in (1, LIVE_CHUNK):                   # warm-up
        Auralizer(source=frames[:LIVE_CHUNK], config=cfg, device="cuda",
                  chunk_frames=chunk).run_until_exhausted(timeout=300)
    torch.cuda.synchronize()
    counts = {}
    for chunk, path in ((1, "live_frame"), (LIVE_CHUNK, "live_chunk")):
        aur = Auralizer(source=clip, config=cfg, device="cuda",
                        chunk_frames=chunk)
        reset_counts()
        t0 = time.perf_counter()
        aur.run_until_exhausted(timeout=300)
        wall = time.perf_counter() - t0
        counts[path] = launches = read_counts()
        m = aur.metrics
        got = aur.pull(LIVE_T * cfg.hop_size * cfg.channels)
        need = (["mip_pool_u8", "hann_peak_weighted_sum", "vision_stats"]
                + (["agc_overlap_add"] if chunk == 1 else []))
        if min(launches[k] for k in need) < 1:
            fail(f"live chunk_frames={chunk}: a kernel of the path never "
                 f"launched: {launches}")
        if m["frames_processed"] != LIVE_T or m["dropped_frames"]:
            fail(f"live chunk_frames={chunk}: {m}")
        # The stream dispatches whole chunks and single-steps the rest.
        main = 0 if chunk == 1 else LIVE_T - LIVE_T % chunk
        ref, carry = torch.zeros((0, cfg.channels), device="cuda"), None
        if main:
            ref, carry, _ = chunked.run_offline_batched(
                clip[:main], cfg, chunk=chunk, device="cuda")
        if main < LIVE_T:
            rest, _, _ = step.run_offline(clip[main:], cfg, carry=carry,
                                          device="cuda")
            ref = torch.cat([ref, rest])
        if not np.array_equal(got, ref.cpu().numpy().reshape(-1)):
            fail(f"live chunk_frames={chunk}: the pulled PCM differs from "
                 f"the offline run on the card by "
                 f"{np.abs(got - ref.cpu().numpy().reshape(-1)).max():.3e}")
        if not np.any(got != 0):
            fail(f"live chunk_frames={chunk}: silent")
        say(f"live: Auralizer(...).run_until_exhausted {LIVE_T} frames "
            f"1080x1920 stereo 48 kHz chunk_frames={chunk}: "
            f"{1e3 * wall / LIVE_T:.3f} ms/frame, latency p50 "
            f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms "
            f"(unpaced, pipeline depth 4); PCM equal to the offline run on "
            f"the card; launches {launches} ({smi})")

    crop = np.ascontiguousarray(clip[:, :256, :256])
    runs = (("per frame", step.run_offline, {}),
            ("chunked", chunked.run_offline_batched, {"chunk": LIVE_CHUNK}))
    for label, run, kw in runs:
        a_gpu, _, d_gpu = run(crop, cfg, debug=True, device="cuda", **kw)
        a_cpu, _, d_cpu = run(crop, cfg, debug=True, device="cpu", **kw)
        if not torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"]):
            fail(f"live 256x256 crop {label}: hues differ card vs CPU")
        err = float((a_gpu.cpu() - a_cpu).abs().max())
        if not err <= 1e-4:
            fail(f"live 256x256 crop {label}: PCM card vs CPU {err:.3e}")
        say(f"live: 256x256 crop {label} card vs CPU: hues equal "
            f"({len(torch.unique(d_cpu['hues']))} distinct), PCM max diff "
            f"{err:.3e}")
    return counts


def kind_of(name: str) -> str:
    """The kind of a device event, for the profile's table."""
    for kernel in ("mip_pool_u8", "hann_peak_weighted_sum", "vision_stats",
                   "agc_overlap_add"):
        if kernel in name:
            return kernel
    if name.startswith("Memcpy"):
        return name.split(" (")[0]                  # Memcpy HtoD / DtoH
    if "fft" in name.lower():
        return "cuFFT"
    if "elementwise" in name or "vectorized" in name:
        return "PyTorch elementwise"
    if "reduce" in name.lower():
        return "PyTorch reductions"
    return "other"


def phase_profile(frames: np.ndarray, smi: str) -> None:
    """The live path under torch.profiler, per frame and in chunks: device
    events per frame by kind, host-to-device copies per dispatch, and the
    device's busy share of the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from vaudio_torch.api import Auralizer
    cfg = live_config()
    T = 16
    for chunk in (1, LIVE_CHUNK):
        aur = Auralizer(source=frames[:T], config=cfg, device="cuda",
                        chunk_frames=chunk)
        aur.run_until_exhausted(timeout=300)        # warm-up
        aur = Auralizer(source=frames[:T], config=cfg, device="cuda",
                        chunk_frames=chunk)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aur.run_until_exhausted(timeout=300)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows: dict = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            n, us = rows.get(kind_of(e.name), (0, 0.0))
            rows[kind_of(e.name)] = (n + 1, us + e.time_range.elapsed_us())
        busy_ms = sum(us for _, us in rows.values()) / 1e3
        if busy_ms <= 0:
            say(f"profile: live chunk_frames={chunk}: torch.profiler "
                f"recorded no device events: not measured")
            continue
        dispatches = aur.metrics["dispatches"]
        table = ", ".join(f"{k} {n / T:.2f}/frame {us / 1e3 / T:.4f} ms"
                          for k, (n, us) in sorted(rows.items(),
                                                   key=lambda r: -r[1][1]))
        say(f"profile: live chunk_frames={chunk}, {T} frames 1080x1920 "
            f"stereo: wall {wall_ms / T:.3f} ms/frame, device busy "
            f"{busy_ms / T:.4f} ms/frame ({100 * busy_ms / wall_ms:.1f}% of "
            f"the wall, idle {100 - 100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(n for n, _ in rows.values()) / T:.1f} device events/frame, "
            f"HtoD copies {rows.get('Memcpy HtoD', (0, 0))[0] / dispatches:.1f}"
            f"/dispatch ({dispatches} dispatches); by kind: {table} ({smi})")


def phase_realtime(frames: np.ndarray, smi: str) -> None:
    import threading

    from vaudio_torch.api import Auralizer
    cfg = live_config()
    aur = Auralizer(source=frames[:REALTIME_T], config=cfg, device="cuda",
                    realtime=True)
    pulled = []
    aur.start()
    consumer = threading.Thread(target=lambda: pulled.extend(
        b.size for b in aur.audio_stream(quantum=512, pace=True)))
    consumer.start()
    deadline = time.monotonic() + 120
    while aur.is_running and time.monotonic() < deadline:
        time.sleep(0.01)
    if aur.is_running:
        aur.stop()
        fail("real-time run did not finish within 120 s")
    aur.raise_if_failed()
    m = aur.metrics
    consumer.join(timeout=30)
    if m["frames_processed"] != REALTIME_T:
        fail(f"real-time run: {m}")
    say(f"realtime: {REALTIME_T} frames 1080x1920 stereo 48 kHz paced at "
        f"{cfg.video_fps:g} fps, per frame (K1-K4): latency p50 "
        f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms "
        f"(+{m['hardware_latency_ms']:.3f} ms sink), achieved "
        f"{m['achieved_fps']:.2f} fps, dropped {m['dropped_frames']}, "
        f"underrun {m['underrun_samples']} samples, pulled {sum(pulled)} "
        f"samples ({smi})")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs "
             "only on a GPU")
    import vaudio_torch  # noqa: F401  (fails outside the repository)
    smi = phase_env()
    phase_build(smi)
    t0 = time.perf_counter()
    frames = structured_frames(0, REALTIME_T, 1080, 1920)
    say(f"frames: {REALTIME_T} structured u8 frames 1080x1920 made in "
        f"{time.perf_counter() - t0:.1f} s on the host ({smi})")
    kernels = [phase_k1(smi), *phase_k2(smi)]
    counts = {"offline": phase_offline(frames[:CHUNK_T], smi)}
    kernels += [*phase_k3(frames, smi), phase_k4(smi)]
    counts.update(phase_live(frames, smi))
    phase_profile(frames, smi)
    phase_realtime(frames, smi)
    for k in kernels:
        base = re.sub(r"_t\d+$", "", k["name"])
        k["launches"] = counts[k["path"]][base]
        k["launches_by_path"] = {p: c[base] for p, c in counts.items()}
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
