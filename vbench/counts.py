"""The yardstick's fixed numbers: the card's published peaks, the bytes
and operations of the flagship step worked out from a configuration's
shapes, and the card's identity.

The counts are frozen here so that they stay the same whatever implements
the step; they were taken from the program's own accounting as of this
benchmark's first version (the per-kernel byte and operation counts of
its smoke run and its ``bench`` command's floor).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional

#: One H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s, and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: Operations of one Hann-peak evaluation of the spectrum contraction: the
#: distance (2) and the peak (rint, the reduced fraction, a 5-term
#: polynomial, the parity sign, the factored numerator and denominator,
#: one divide, the limits: 25); each output column adds 2 (a
#: multiply-add).
K2_PEAK_OPS = 27
#: Operations per output texel of the mip pool beyond its block sum.
K1_EPILOGUE_OPS = 2
#: Operations per mip pixel of the vision stage: HSI and gate ~20, the
#: acos ~15, the bin and cell ~12, the stencils ~27, the statistics 8, the
#: histogram add 1, loop and index arithmetic (90).
VISION_PIXEL_OPS = 90


def shapes(auralizer: Dict) -> Dict[str, int]:
    """The step's sizes from a configuration's ``auralizer`` group: F
    bins, NP partials, K contraction columns, the FFT length and the hop,
    the channels and the cells."""
    nfft = int(auralizer["nfft"])
    grid = int(auralizer["grid_size"])
    channels = int(auralizer["channels"])
    cells = grid * grid
    return {"F": max(2, (nfft - 2) // 2),
            "NP": cells * (int(auralizer["num_harmonics"])
                           + int(auralizer["num_bessel_synth"])),
            "K": 2 * channels, "nfft": nfft, "hop": nfft // 2,
            "C": channels, "cells": cells}


def k2_ops(auralizer: Dict, frames: int) -> float:
    """The spectrum contraction's operations over ``frames`` frames:
    F NP (27 + 2K) a frame."""
    s = shapes(auralizer)
    return float(frames) * s["F"] * s["NP"] * (K2_PEAK_OPS + 2 * s["K"])


def k2_bound_s(auralizer: Dict, frames: int, launches: int) -> float:
    """The contraction's least time over ``frames`` frames in ``launches``
    launches: the larger of its operations over the f32 peak and its bytes
    (the bin grid once a launch; partials, scales and weights in; the
    spectrum out) over HBM."""
    s = shapes(auralizer)
    nbytes = 4.0 * (launches * s["F"] + frames * s["NP"] * (2 + s["K"])
                    + frames * s["F"] * s["K"])
    return max(k2_ops(auralizer, frames) / F32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def step_ops(auralizer: Dict, height: int, width: int) -> float:
    """Operations of one frame through the whole step: the mip pool, the
    vision stage, the contraction, the inverse FFT and the audio tail."""
    s = shapes(auralizer)
    level = int(auralizer["mip_level"])
    mip_px = (height >> level) * (width >> level)
    fft = 2.5 * s["nfft"] * max(1, s["nfft"].bit_length() - 1)
    return (height * width * 3 + K1_EPILOGUE_OPS * 3 * mip_px
            + VISION_PIXEL_OPS * mip_px
            + s["F"] * s["NP"] * (K2_PEAK_OPS + 2 * s["K"])
            + s["C"] * fft
            + 6 * s["C"] * s["nfft"] + s["C"] * s["hop"])


def step_bytes(auralizer: Dict, height: int, width: int) -> float:
    """Bytes one frame must move at the least: its u8 RGB pixels read
    once and its float32 PCM hop written once."""
    s = shapes(auralizer)
    return float(height * width * 3 + 4 * s["C"] * s["hop"])


def step_floor_s(auralizer: Dict, height: int, width: int) -> float:
    """The least time of one frame: the larger of its bytes over HBM and
    its operations over the f32 peak."""
    return max(step_bytes(auralizer, height, width) / HBM_BYTES_PER_S,
               step_ops(auralizer, height, width) / F32_OPS_PER_S)


def nvidia_smi_line(index: int = 0) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit``'s line for card
    ``index``, or None without it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def power_limit_w(line: Optional[str]) -> Optional[float]:
    """The watts of an nvidia-smi ``name, power.limit`` line."""
    if not line:
        return None
    try:
        return float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def identity() -> Dict[str, object]:
    """The card's name, power limit, and the torch and CUDA versions."""
    import torch
    line = nvidia_smi_line(torch.cuda.current_device())
    return {"kind": torch.cuda.get_device_name(),
            "power_limit_w": power_limit_w(line),
            "torch": torch.__version__, "cuda": torch.version.cuda}
