#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vaudio_torch``) on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the CUDA kernels from ``vaudio_torch/csrc`` (into
   ``build/vaudio_torch/``);
3. K1, the u8 mip pool, against its plain PyTorch version on
   u8 [8, 1080, 1920, 3] frames at mip 3: integer block sums exact, f32
   within 1 ulp; both times from CUDA events;
4. K2, the Hann-peak contraction, against its plain version at T=64,
   F=2047, NP=496, K=2 and 4: within 1e-5; both times;
5. the main path: ``Auralizer(AuralizerConfig(sample_rate=48000.0,
   channels=2), device="cuda").sonify`` on 128 structured u8 1080p frames,
   with both kernels' launch counts reset before and read after; then the
   same clip cropped to 256x256 through the port on the card and on the CPU
   (equal hue sequences, PCM within 1e-4).

The last lines are the card's name and power limit, a JSON line of the
kernels, and ``{"ok": true, "device": {...}}``.  There is no fallback to the
CPU: without a card the script fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MIP = 3
CHUNK_T = 64                     # the main path's chunk (run_offline_batched)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after a warm-up."""
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


def phase_build() -> None:
    from vaudio_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log = (path.parent / "nvcc.log").read_text().splitlines()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log if "Used" in ln]
    say(f"build: {time.perf_counter() - t0:.2f} s -> {path} | "
        + " ; ".join(regs))


def phase_k1() -> dict:
    from vaudio_torch.ops import pool_kernel as pk
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (8, 1080, 1920, 3), generator=gen,
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
    if got.shape != (8, 3, 135, 240):
        fail(f"K1 output shape {tuple(got.shape)}")
    ulps = int((got.view(torch.int32) - ref.view(torch.int32)).abs().max())
    err = float((got - ref).abs().max())
    if ulps > 1:
        fail(f"K1 differs from the plain version by {ulps} ulp")
    ms = cuda_ms(lambda: pk.mip_pool(frames, MIP, scale=1.0 / 255.0))
    plain_ms = cuda_ms(lambda: pk.mip_pool_plain(planes, MIP, 1.0 / 255.0))
    say(f"K1 mip_pool u8 [8,1080,1920,3] mip {MIP}: sums exact, "
        f"max {ulps} ulp, max_abs_err {err:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return dict(name="mip_pool_u8", route="cuda",
                source="vaudio_torch/csrc/pool_kernel.cu",
                replaces="vaudio/ops/pool_kernel.py:130",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2() -> dict:
    from vaudio.config import AuralizerConfig
    from vaudio_torch.ops import spectrum_kernel as sk
    cfg = AuralizerConfig(sample_rate=48000.0)
    rng = np.random.default_rng(0)
    T, NP, F = CHUNK_T, 496, cfg.num_bins
    freqs = torch.as_tensor(cfg.bin_frequencies(), device="cuda")
    pf = torch.as_tensor(rng.uniform(20, 20000, (T, NP)).astype(np.float32),
                         device="cuda")
    scale = torch.as_tensor((rng.choice([1.0, 0.2], (T, NP))
                             / cfg.bin_width).astype(np.float32),
                            device="cuda")
    entry = None
    for K in (2, 4):
        w = torch.as_tensor(rng.normal(0, 0.1, (T, NP, K)).astype(np.float32),
                            device="cuda")
        got = sk.hann_peak_weighted_sum(freqs, pf, scale, w)
        ref = sk.hann_peak_weighted_sum_plain(freqs, pf, scale, w)
        torch.cuda.synchronize()
        if got.shape != (T, F, K):
            fail(f"K2 output shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            fail(f"K2 K={K} differs from the plain version by {err:.3e}")
        ms = cuda_ms(lambda: sk.hann_peak_weighted_sum(freqs, pf, scale, w))
        plain_ms = cuda_ms(
            lambda: sk.hann_peak_weighted_sum_plain(freqs, pf, scale, w))
        say(f"K2 hann_peak_weighted_sum T={T} F={F} NP={NP} K={K}: "
            f"max_abs_err {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        entry = dict(name="hann_peak_weighted_sum", route="cuda",
                     source="vaudio_torch/csrc/spectrum_kernel.cu",
                     replaces="vaudio/ops/spectrum_kernel.py:142",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return entry            # K=4: the stereo main path's shape


def phase_slice(smi: str) -> dict:
    from vaudio.config import AuralizerConfig
    from vaudio_torch.api import Auralizer
    from vaudio_torch.ops import pool_kernel, spectrum_kernel
    from vaudio_torch.runtime.chunked import run_offline_batched
    cfg = AuralizerConfig(sample_rate=48000.0, channels=2)
    T = 128
    t0 = time.perf_counter()
    frames = structured_frames(0, T, 1080, 1920)
    say(f"slice: {T} structured u8 frames 1080x1920 made in "
        f"{time.perf_counter() - t0:.1f} s")
    aur = Auralizer(cfg, device="cuda")
    aur.sonify(frames[:8])                          # warm-up (cuFFT plans)
    torch.cuda.synchronize()

    pool_kernel.launches = 0
    spectrum_kernel.launches = 0
    t0 = time.perf_counter()
    audio = aur.sonify(frames)                      # returns host numpy
    wall = time.perf_counter() - t0
    launches = {"mip_pool_u8": pool_kernel.launches,
                "hann_peak_weighted_sum": spectrum_kernel.launches}
    if audio.shape != (T * cfg.hop_size, 2):
        fail(f"slice PCM shape {audio.shape}")
    if not np.all(np.isfinite(audio)) or not np.any(audio != 0):
        fail("slice PCM is not finite or all zero")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    dev_frames = torch.as_tensor(frames, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    aur.sonify(dev_frames)
    wall_dev = time.perf_counter() - t1
    say(f"slice: Auralizer.sonify {T} frames 1080x1920 stereo 48 kHz "
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
    say(f"slice: 256x256 crop card vs CPU: hues equal "
        f"({len(torch.unique(hues_cpu))} distinct), PCM max diff {err:.3e}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs "
             "only on a GPU")
    import vaudio_torch  # noqa: F401  (fails outside the repository)
    smi = phase_env()
    phase_build()
    kernels = [phase_k1(), phase_k2()]
    launches = phase_slice(smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
