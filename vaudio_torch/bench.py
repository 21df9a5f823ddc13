"""Headline benchmark of the PyTorch/CUDA port — the counterpart of the JAX
package's ``bench.py``: the real-time factor of sonifying 1080p30 u8 video
to 48 kHz STEREO PCM on one card.

    python -m vaudio_torch bench
    python -m vaudio_torch.bench

Progress goes to stderr; the last stdout line is ONE JSON object with every
key of ``bench.py``'s record, under the same names and in the same units
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``us_per_frame``,
``static_floor_us``, ``pct_of_floor``, ``ingest_hbm_gbs``, ``stable``,
``valid_reps``, ``slopes_us``, ``scan_path_x_realtime``, ``scan_stable``,
``scan_block``, ``mono_x_realtime``, ``mono_stable``, and
``fallback_upper_bound`` / ``quantize_mips`` where they apply), plus the
card's identity: ``device`` (``torch.cuda.get_device_name``),
``power_limit_w`` (``nvidia-smi``'s power limit), ``torch``, ``cuda`` and
``nvcc`` (whether the CUDA compiler is present).  ``vs_baseline`` is
``value / 10``, the ratio to the README's target of 10x real time, not a
measurement.

Method (``bench.py``'s): u8 frames made on the device before timing go
through the chunk-batched main path (:func:`runtime.chunked.chunk_pipeline`:
K1, K2 and K4 once a call, K3 with ``VAUDIO_BENCH_PALLAS_VISION=1``); the
sequential path is measured beside it as ``scan_path_x_realtime``
(:func:`runtime.chunked.blocked_pipeline` in blocks of
``VAUDIO_BENCH_SCAN_BLOCK``, or a loop of :func:`runtime.step.frame_step`
when that is 0 or 1), and the mono chunked path as ``mono_x_realtime``.  The
time a frame is the SLOPE between a small and a large chunk length, with
carries chained through every timed call from ``init_carry`` on, which
cancels the per-call overhead; each chunk length's time is the minimum of
two loops of ``VAUDIO_BENCH_ITERS`` calls, host clock around
``torch.cuda.synchronize()`` (the path is host-bound: its serial EMAs are
Python loops of small launches, so the wall clock is the figure; CUDA
events around the same loop are logged as a cross-check).  Adaptive reps:
at least ``VAUDIO_BENCH_SLOPE_REPS`` slopes, more until three positive ones
agree within 40% of their median or ``VAUDIO_BENCH_MAX_REPS`` is reached;
the figure is the median of the middle three positive slopes, and when
every slope is <= 0 the best whole-call time a frame at the large chunk (an
upper bound, flagged ``fallback_upper_bound``).  Every run salts its seeds.

After the first call of each measurement on the card, the kernels' launch
counters (``ops.pool_kernel.launches``, ``ops.spectrum_kernel.launches``,
``ops.audio_kernel.launches``, ``ops.vision_kernel.launches``) are logged,
and the run exits 1 without a JSON line if a kernel the path runs did not
launch: K1 (u8 frames at mip 1-7 without ``QUANTIZE``), K2 (always), K4
(the chunked and blocked paths; the per-frame step with ``PALLAS`` or
``PALLAS_AUDIO``), K3 (with ``PALLAS_VISION`` where
:func:`ops.vision_kernel.supports` takes the mip; at 4K it does not, and K3
is then expected not to launch).

The static floor (``static_floor_us``), from the card:

- the u8 frame read: ``h * w * 3`` bytes over ``VAUDIO_BENCH_HBM_GBS``
  (default 3350 GB/s, the HBM3 rate of an H100 SXM on NVIDIA's data sheet);
- the spectrum contraction (K2): ``F * NP * (27 + 2K)`` operations over 67
  TFLOP/s (the H100 SXM's f32 rate outside the tensor cores, the same data
  sheet), with F the config's bins, NP its cells times partials, K its
  contraction's weight columns (2 a channel) and 27 operations a peak
  evaluation (``chip_smoke.py``'s count of K2, copied here).

At 1080p stereo that is 1.857 + 0.530 = 2.39 us a frame; ``pct_of_floor``
= floor / measured.

Environment (``bench.py``'s names):

  VAUDIO_BENCH_RES=HxW            frame size (default 1080x1920)
  VAUDIO_BENCH_CHUNKS=a,b         the slope's chunk lengths (default 16,128)
  VAUDIO_BENCH_ITERS=N            calls in each timed loop (default 12)
  VAUDIO_BENCH_SLOPE_REPS=N       least slopes (default 3)
  VAUDIO_BENCH_MAX_REPS=N         most slopes (default 8)
  VAUDIO_BENCH_PALLAS=0/1         ``use_pallas`` (K4 in the per-frame step)
  VAUDIO_BENCH_PALLAS_AUDIO=0/1   ``use_pallas_audio`` (the same)
  VAUDIO_BENCH_PALLAS_POOL=0/1    ``use_pallas_pool`` (default 1)
  VAUDIO_BENCH_PALLAS_VISION=0/1  ``use_pallas_vision`` (K3)
  VAUDIO_BENCH_MATMUL_IRFFT=0/1   ``use_matmul_irfft``
  VAUDIO_BENCH_MATMUL_EMA=0/1     ``use_matmul_ema``
  VAUDIO_BENCH_FAST_ACOS=0/1      ``fast_hue_acos`` (default 1)
  VAUDIO_BENCH_QUANTIZE=0/1       ``quantize_mips``
  VAUDIO_BENCH_QUANTIZE_INT8=0/1  ``quantize_mips_int8``
  VAUDIO_BENCH_CHANNELS=1/2       the headline's channels (default 2)
  VAUDIO_BENCH_MONO=0/1           also measure mono (default 1, if stereo)
  VAUDIO_BENCH_SCAN=0/1           also measure the sequential path (default 1)
  VAUDIO_BENCH_SCAN_BLOCK=N       its blocks (default 8; 0 or 1 per frame)
  VAUDIO_BENCH_HBM_GBS=x          the floor's memory rate (default 3350)

What differs from ``bench.py`` because the device is a GPU: the card, or
the CPU only with ``VAUDIO_PLATFORM=cpu`` (:func:`cli.platform_device`;
without either the run exits 1 with :func:`vaudio_torch.device`'s message,
in place of ``bench.py``'s relay watchdog and ``VAUDIO_BENCH_INIT_TIMEOUT``);
frames made in one ``torch.randint`` on the device (no 8-frame slices);
no compile cache (``VAUDIO_JAX_CACHE``): the kernels build once into
``build/``, and the first call's log line includes their load;
``VAUDIO_BENCH_UNROLL`` (``lax.scan``'s unroll) has no counterpart in eager
PyTorch and is not read.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

from vaudio_torch.cli import platform_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import hann_window_norm
from vaudio_torch.ops import (_build, audio_kernel, pool_kernel,
                              spectrum_kernel, vision_kernel)
from vaudio_torch.runtime.chunked import blocked_pipeline, chunk_pipeline
from vaudio_torch.runtime.step import (default_params, frame_step,
                                       init_carry, params_to_device)
from vaudio_torch.synth.spectrum import SynthConstants

#: The keys the port's record adds to ``bench.py``'s: the card's identity.
IDENTITY_KEYS = ("device", "power_limit_w", "torch", "cuda", "nvcc")
#: H100 SXM at 700 W (NVIDIA's data sheet): HBM3 GB/s, f32 operations/s
#: outside the tensor cores.
HBM_GBS = 3350.0
F32_OPS_PER_S = 67e12
#: Operations of one K2 peak evaluation (``chip_smoke.py``'s count); K2
#: adds 2 per output column.
K2_PEAK_OPS = 27
#: Three positive slopes agree when their spread is within this share of
#: the positive slopes' median.
STABLE_SPREAD = 0.4


class KernelCheckError(RuntimeError):
    """A kernel of the measured path did not launch on the card."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _flag(name: str, default: str = "0") -> bool:
    return os.environ.get(f"VAUDIO_BENCH_{name}", default) == "1"


# ---------------------------------------------------------------------------
# The slope statistics (bench.py:268-345), pure functions
# ---------------------------------------------------------------------------

def mid3(slopes) -> list:
    """The middle three of the positive slopes, sorted (all of them when
    fewer than three)."""
    v = sorted(s for s in slopes if s > 0)
    return v[(len(v) - 3) // 2:][:3] if len(v) >= 3 else v


def is_stable(slopes) -> bool:
    """At least three positive slopes whose middle three lie within 40% of
    the positive slopes' median."""
    valid = sorted(s for s in slopes if s > 0)
    if len(valid) < 3:
        return False
    mid = mid3(slopes)
    return (mid[-1] - mid[0]) <= STABLE_SPREAD * statistics.median(valid)


def run_reps(slope_at: Callable[[int], float], n_reps: int, max_reps: int,
             label: str = "bench") -> Tuple[List[float], bool]:
    """Slopes ``slope_at(rep)`` for rep = 0, 1, ...: stop once at least
    ``n_reps`` were taken and :func:`is_stable` holds, or after
    ``max_reps``.  Returns (slopes, stable)."""
    slopes: List[float] = []
    while True:
        slopes.append(slope_at(len(slopes)))
        valid = sorted(s for s in slopes if s > 0)
        if len(slopes) >= n_reps and len(valid) >= 3:
            if is_stable(slopes):
                return slopes, True
            log(f"{label}: slopes unstable "
                f"({[round(s * 1e3) for s in valid]} us) — extra rep")
        if len(slopes) >= max_reps:
            return slopes, False


def per_frame_ms(slopes) -> Optional[float]:
    """The median of the middle three positive slopes (the plain median
    when the gate passed, outlier-trimmed when it did not); None when no
    slope is positive."""
    mid = mid3(slopes)
    return statistics.median(mid) if mid else None


# ---------------------------------------------------------------------------
# The static floor, from the card's published rates
# ---------------------------------------------------------------------------

def static_floor_us(h: int, w: int, cfg, hbm_gbs: float = HBM_GBS
                    ) -> Tuple[float, float]:
    """(the u8 frame read, the spectrum contraction) in us a frame: h*w*3
    bytes over ``hbm_gbs`` GB/s, and F * NP * (27 + 2K) operations over the
    f32 rate, K = 2 * channels."""
    frame_us = h * w * 3 / (hbm_gbs * 1e3)
    n_partials = cfg.num_cells * (cfg.num_harmonics + cfg.num_bessel_synth)
    k = 2 * cfg.channels
    ops = cfg.num_bins * n_partials * (K2_PEAK_OPS + 2 * k)
    return frame_us, ops / F32_OPS_PER_S * 1e6


# ---------------------------------------------------------------------------
# The card's identity
# ---------------------------------------------------------------------------

def nvidia_smi_line(index: int = 0) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line of card ``index``, or None without nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[index].strip() if index < len(lines) else None


def power_limit_w(smi_line: Optional[str]) -> Optional[float]:
    """The watts of an nvidia-smi ``name, power.limit`` line."""
    if not smi_line:
        return None
    try:
        return float(smi_line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def nvcc_present() -> bool:
    """Whether the CUDA compiler the kernels build with is installed."""
    try:
        _build._nvcc()
    except RuntimeError:
        return False
    return True


def identity(dev: torch.device) -> dict:
    """The card's identity keys of the record (on the CPU: device "cpu"
    and no power limit)."""
    smi = None
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        smi = nvidia_smi_line(index)
        log(f"bench: nvidia-smi: {smi}")
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type),
            "power_limit_w": power_limit_w(smi),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc_present()}


# ---------------------------------------------------------------------------
# The timed callables: the port's main path
# ---------------------------------------------------------------------------

def bench_config(channels: int):
    """``AuralizerConfig`` at 48 kHz with the ``VAUDIO_BENCH_*`` flags."""
    return AuralizerConfig(
        sample_rate=48000.0, use_pallas=_flag("PALLAS"),
        use_pallas_audio=_flag("PALLAS_AUDIO"),
        use_pallas_pool=_flag("PALLAS_POOL", "1"),
        use_pallas_vision=_flag("PALLAS_VISION"),
        use_matmul_irfft=_flag("MATMUL_IRFFT"),
        use_matmul_ema=_flag("MATMUL_EMA"),
        fast_hue_acos=_flag("FAST_ACOS", "1"),
        quantize_mips=_flag("QUANTIZE"),
        quantize_mips_int8=_flag("QUANTIZE_INT8"), channels=channels)


def make_runner(cfg, mode: str, scan_block: int, device):
    """``run(carry, frames) -> (carry, {"pcm": ...})`` on ``device``'s
    tensors: ``mode`` "chunked" is :func:`chunk_pipeline`, "scan" is
    :func:`blocked_pipeline` in blocks of ``scan_block`` or, when that is 0
    or 1, a loop of :func:`frame_step` with the PCM stacked (the JAX
    package's ``lax.scan``).  Constants, window and params are built once."""
    consts = SynthConstants.create(cfg, device)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=device)
    params = params_to_device(default_params(cfg), cfg, device)

    if mode == "chunked":
        def run(carry, frames):
            return chunk_pipeline(carry, frames, params, cfg, consts, window)
    elif scan_block > 1:
        def run(carry, frames):
            return blocked_pipeline(carry, frames, params, cfg, consts,
                                    window, block=scan_block)
    else:
        def run(carry, frames):
            pcm = []
            for t in range(frames.shape[0]):
                carry, out = frame_step(carry, frames[t], params, cfg,
                                        consts, window)
                pcm.append(out["pcm"])
            return carry, {"pcm": torch.stack(pcm)}
    return run


def expected_kernels(cfg, mode: str, scan_block: int, h: int,
                     w: int) -> dict:
    """Which kernels one call of the path launches on the card, by counter
    name: K1 ``pool``, K2 ``spectrum``, K4 ``audio``, K3 ``vision``."""
    level = cfg.mip_level
    per_frame = mode == "scan" and scan_block <= 1
    return {"pool": 1 <= level <= 7 and not cfg.quantize_mips,
            "spectrum": True,
            "audio": (not per_frame or cfg.use_pallas
                      or cfg.use_pallas_audio),
            "vision": (cfg.use_pallas_vision
                       and vision_kernel.supports(h >> level, w >> level,
                                                  cfg))}


def launch_counts() -> dict:
    """The kernels' launch counters (the RGB entry of K1)."""
    return {"pool": pool_kernel.launches,
            "spectrum": spectrum_kernel.launches,
            "audio": audio_kernel.launches,
            "vision": vision_kernel.launches}


def check_launches(label: str, before: dict, after: dict,
                   expected: dict) -> dict:
    """The launches between two :func:`launch_counts`, logged; raises
    :class:`KernelCheckError` if an expected kernel launched no time."""
    got = {k: after[k] - before[k] for k in after}
    names = {"pool": "K1", "spectrum": "K2", "audio": "K4", "vision": "K3"}
    log(f"{label}: first call's launches: "
        + ", ".join(f"{names[k]} {v}" for k, v in got.items())
        + " (expected: " + ", ".join(names[k] for k, on in expected.items()
                                     if on) + ")")
    missing = [names[k] for k, on in expected.items() if on and not got[k]]
    if missing:
        raise KernelCheckError(f"{label}: {', '.join(missing)} did not "
                               f"launch on the card: {got}")
    return got


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# One measurement: a slope's chunk lengths, timed, rep by rep
# ---------------------------------------------------------------------------

def measure(ch: int, mode: str, dev, h: int, w: int, chunks, iters: int,
            scan_block: int, n_reps: int, max_reps: int, salt: int):
    """One of the three measurements.  Returns (x real time, ms a frame,
    quality dict)."""
    cfg = bench_config(ch)
    run = make_runner(cfg, mode, scan_block, dev)
    label = f"bench[ch={ch},{mode}]"
    expected = expected_kernels(cfg, mode, scan_block, h, w)
    cuda = dev.type == "cuda"
    checked = False

    def bench_chunk(T: int, seed0: int) -> float:
        """ms a call of ``run`` on T device frames, the better of two
        timed loops, the carry chained from init_carry on."""
        nonlocal checked
        g = torch.Generator(device=dev)
        g.manual_seed(seed0)
        frames = torch.randint(0, 256, (T, h, w, 3), dtype=torch.uint8,
                               device=dev, generator=g)
        carry = init_carry(cfg, dev)
        _sync(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        carry, outs = run(carry, frames)
        _sync(dev)
        log(f"{label}: chunk{T} first call (incl. the kernels' load) "
            f"{time.perf_counter() - t0:.1f}s")
        if not checked:
            checked = True
            if cuda:
                check_launches(label, before, launch_counts(), expected)
            else:
                log(f"{label}: CPU tensors run the kernels' plain versions; "
                    f"no launch to check")
        # The MIN of two timed loops: host pauses only ever inflate one.
        best = float("inf")
        for _ in range(2):
            if cuda:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
            _sync(dev)
            t0 = time.perf_counter()
            if cuda:
                events[0].record()
            for _ in range(iters):
                carry, outs = run(carry, frames)
            if cuda:
                events[1].record()
            _sync(dev)
            wall = (time.perf_counter() - t0) / iters * 1e3
            best = min(best, wall)
            if cuda:
                log(f"{label}: chunk{T} {wall:.3f} ms/call wall, "
                    f"{events[0].elapsed_time(events[1]) / iters:.3f} by "
                    f"CUDA events")
        return best

    def slope_at(rep: int) -> float:
        t_small = bench_chunk(chunks[0], salt + rep)
        t_big = bench_chunk(chunks[1], salt + 1000 + rep)
        ms = (t_big - t_small) / (chunks[1] - chunks[0])
        log(f"{label} rep{rep}: chunk{chunks[0]}={t_small:.1f}ms "
            f"chunk{chunks[1]}={t_big:.1f}ms -> {ms * 1e3:.0f} us/frame")
        return ms

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    slopes, stable = run_reps(slope_at, n_reps, max_reps, label)
    valid = [s for s in slopes if s > 0]
    ms_per_frame = per_frame_ms(slopes)
    fallback = ms_per_frame is None
    if fallback:
        ms_per_frame = bench_chunk(chunks[1], salt + 4242) / chunks[1]
    fps = 1000.0 / ms_per_frame
    rtf = fps / cfg.video_fps
    if fallback:
        log(f"{label}: all {len(slopes)} slopes non-positive; per-call "
            f"UPPER BOUND {ms_per_frame:.3f} ms/frame (NOT a slope) -> "
            f"{fps:.0f} frames/s = {rtf:.1f}x realtime @30fps")
    else:
        log(f"{label}: median {ms_per_frame:.3f} ms/frame over "
            f"{len(valid)}/{len(slopes)} slopes "
            f"({'stable' if stable else 'UNSTABLE'}) -> {fps:.0f} frames/s "
            f"= {rtf:.1f}x realtime @30fps; audio out "
            f"{fps * cfg.hop_size * ch / 1e6:.2f} Msamples/s")
    if cuda:
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    quality = {"slopes_us": [round(s * 1e3, 2) for s in slopes],
               "valid_reps": len(valid), "stable": stable,
               "fallback_upper_bound": fallback}
    return rtf, ms_per_frame, quality


def headline_record(rtf: float, ms_per_frame: float, quality: dict,
                    channels: int, h: int, w: int, hbm_gbs: float) -> dict:
    """``bench.py``'s record of the headline measurement (bench.py:357-378)
    with the card's floor."""
    cfg = bench_config(channels)
    frame_us, spectrum_us = static_floor_us(h, w, cfg, hbm_gbs)
    floor = frame_us + spectrum_us
    log(f"bench: static floor {floor:.3f} us/frame = frame read "
        f"{frame_us:.3f} ({hbm_gbs:g} GB/s) + spectrum {spectrum_us:.3f} "
        f"(K2's operations at {F32_OPS_PER_S / 1e12:g} TFLOP/s f32)")
    us_per_frame = ms_per_frame * 1e3
    record = {
        "metric": ("realtime_factor_1080p30_to_48kHz_stereo_per_chip"
                   if channels == 2 else
                   "realtime_factor_1080p30_to_48kHz_per_chip"),
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 10.0, 3),
        "us_per_frame": round(us_per_frame, 2),
        "static_floor_us": round(floor, 2),
        "pct_of_floor": round(100.0 * floor / us_per_frame, 1),
        "ingest_hbm_gbs": round(h * w * 3 / (us_per_frame * 1e3), 1),
        "stable": quality["stable"],
        "valid_reps": quality["valid_reps"],
        "slopes_us": quality["slopes_us"],
    }
    if quality["fallback_upper_bound"]:
        record["fallback_upper_bound"] = True
    if cfg.quantize_mips:
        record["quantize_mips"] = True
    return record


def main() -> int:
    dev = platform_device()
    res = os.environ.get("VAUDIO_BENCH_RES", "1080x1920")
    h, w = (int(x) for x in res.split("x"))
    chunks = [int(x) for x in
              os.environ.get("VAUDIO_BENCH_CHUNKS", "16,128").split(",")]
    iters = int(os.environ.get("VAUDIO_BENCH_ITERS", "12"))
    channels = int(os.environ.get("VAUDIO_BENCH_CHANNELS", "2"))
    also_mono = _flag("MONO", "1") and channels == 2
    scan_block = int(os.environ.get("VAUDIO_BENCH_SCAN_BLOCK", "8"))
    n_reps = int(os.environ.get("VAUDIO_BENCH_SLOPE_REPS", "3"))
    max_reps = int(os.environ.get("VAUDIO_BENCH_MAX_REPS", "8"))
    hbm_gbs = float(os.environ.get("VAUDIO_BENCH_HBM_GBS", str(HBM_GBS)))
    ident = identity(dev)
    log(f"bench: device={dev} ({ident['device']}) frame={h}x{w} "
        f"chunks={chunks} iters={iters} torch {ident['torch']} cuda "
        f"{ident['cuda']} nvcc {ident['nvcc']}")
    # Per-process seed salt (bench.py:270): every run's frames differ.
    salt = (time.time_ns() ^ os.getpid()) % (1 << 20)
    common = dict(dev=dev, h=h, w=w, chunks=chunks, iters=iters,
                  scan_block=scan_block, n_reps=n_reps, max_reps=max_reps,
                  salt=salt)
    try:
        rtf, ms_per_frame, quality = measure(channels, "chunked", **common)
        record = headline_record(rtf, ms_per_frame, quality, channels, h, w,
                                 hbm_gbs)
        if _flag("SCAN", "1"):
            s_rtf, _, s_q = measure(channels, "scan", **common)
            record["scan_path_x_realtime"] = round(s_rtf, 2)
            record["scan_stable"] = s_q["stable"]
            record["scan_block"] = scan_block
        if also_mono:
            m_rtf, _, m_q = measure(1, "chunked", **common)
            record["mono_x_realtime"] = round(m_rtf, 2)
            record["mono_stable"] = m_q["stable"]
    except KernelCheckError as e:
        log(f"bench: FAIL: {e}")
        return 1
    record.update(ident)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
