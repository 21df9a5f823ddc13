"""Core DSP primitives — the PyTorch port of :mod:`vaudio.dsp.core`.

Each function keeps the JAX version's op order, so that the element
functions agree bit for bit where no transcendental is involved (PyTorch
runs every op eagerly: nothing is contracted into an FMA).  All accept any
leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = 2.0 * np.pi


def hann_window_norm(n: int) -> np.ndarray:
    """vDSP_HANN_NORM Hann window, ``sqrt(2/3) * (1 - cos(2 pi k / N))``
    (SoundEngine.swift:97-101); a host constant."""
    k = np.arange(n, dtype=np.float64)
    w = np.sqrt(2.0 / 3.0) * (1.0 - np.cos(_TWO_PI * k / n))
    return w.astype(np.float32)


def sinc(x):
    """Normalized sinc, 1 at x=0 (SpectrumCompute.metal:55-57)."""
    px = np.float32(np.pi) * x
    return torch.where(x == 0.0, torch.ones_like(x), torch.sin(px) / px)


def hann_sinc_peak(d):
    """Closed-form DFT of a Hann window at bin distance ``d``:
    0.5 sinc(d) - 0.25 (sinc(d-1) + sinc(d+1))."""
    return 0.5 * sinc(d) - 0.25 * (sinc(d - 1.0) + sinc(d + 1.0))


# Minimax odd polynomial for sin(pi x) on |x| <= 0.5 (vaudio.dsp.core).
_SINPI_A1 = float(np.float32(3.1415925))
_SINPI_A3 = float(np.float32(-5.167707))
_SINPI_A5 = float(np.float32(2.5500314))
_SINPI_A7 = float(np.float32(-0.5980451))
_SINPI_A9 = float(np.float32(0.07722007))


def sinpi_reduced(x):
    """sin(pi x) for |x| <= 0.5 as a 5-term odd polynomial."""
    x2 = x * x
    p = x2 * _SINPI_A9 + _SINPI_A7
    for c in (_SINPI_A5, _SINPI_A3, _SINPI_A1):
        p = p * x2 + c
    return x * p


def hann_sinc_peak_fast(d):
    """Transcendental-free :func:`hann_sinc_peak` — one reduced sine
    polynomial and one divide, the factored denominator
    ``pi d (d-1) (d+1)`` and exact limits at d = 0 and |d| = 1.  This is
    the element function of kernel K2 (``csrc/spectrum_kernel.cu``)."""
    pi = float(np.float32(np.pi))
    n = torch.round(d)                       # half to even, as jnp.round
    frac = d - n
    s = sinpi_reduced(frac)
    s = torch.where(torch.remainder(n, 2.0) == 0.0, s, -s)
    num = d * d - 0.5
    den = pi * d * (d - 1.0) * (d + 1.0)
    w = s * (num / den)
    w = torch.where(d == 0.0, torch.full_like(w, 0.5), w)
    return torch.where(torch.abs(d) == 1.0, torch.full_like(w, -0.25), w)


def hue_to_f0(hue_bin, base: float = 220.0, octaves: float = 3.0,
              bins: float = 360.0):
    """f0 = 220 * 2^(3 * hue / 360) (SpectrumCompute.metal:108)."""
    h = hue_bin.to(torch.float32)
    return float(np.float32(base)) * torch.exp2(
        h / float(np.float32(bins)) * float(np.float32(octaves)))


def find_closest_index(freqs, targets):
    """Nearest-bin snap of ``targets`` onto the ascending ``freqs`` grid
    (HelperFunctions.swift:233-261): on an exact midpoint the lower index
    wins; below the grid -> 0, above it -> n-1."""
    n = freqs.shape[0]
    lo = torch.searchsorted(freqs, targets.contiguous(), side="left")
    lo_c = lo.clamp(1, n - 1)
    pick_lo = (torch.abs(freqs[lo_c] - targets)
               < torch.abs(freqs[lo_c - 1] - targets))
    idx = torch.where(pick_lo, lo_c, lo_c - 1)
    idx = torch.where(lo <= 0, torch.zeros_like(idx), idx)
    idx = torch.where(lo >= n, torch.full_like(idx, n - 1), idx)
    return idx


def irfft_from_half(spectrum):
    """(..., F, 2) half spectrum (re, im) -> (..., 2(F+1)) real frames.

    DC and Nyquist are zero (the reference's mirrorAndConjugate layout,
    HelperFunctions.swift:110-129); one ``torch.fft.irfft`` (cuFFT on the
    card) as the JAX package leaves it to XLA's FFT.
    """
    F = spectrum.shape[-2]
    half = torch.complex(spectrum[..., 0], spectrum[..., 1])
    rspec = torch.nn.functional.pad(half, (1, 1))      # F+2 = nfft/2+1
    return torch.fft.irfft(rspec, n=2 * (F + 1)).to(torch.float32)


def sigmoid_normalize(x, M, k: float = 2.0):
    """Soft AGC curve rescaled so g(0)=0, g(1)=1, at t = x/M
    (HelperFunctions.swift:132-138)."""
    kf = float(np.float32(k))
    scaled = x / M
    g = 1.0 / (1.0 + torch.exp(-kf * (scaled - 0.5)))
    g0 = 1.0 / (1.0 + np.exp(-k * (0.0 - 0.5)))
    g1 = 1.0 / (1.0 + np.exp(-k * (1.0 - 0.5)))
    return (g - float(np.float32(g0))) / float(np.float32(g1 - g0))


def agc_normalize(signal, running_max, attack, release):
    """Attack/release AGC of one frame (SoundEngine.swift:412-426); the
    peak is global over all of ``signal``.  Returns (normalized,
    new_running_max)."""
    frame_peak = torch.amax(torch.abs(signal)) + 1e-9
    attacked = attack * frame_peak + (1.0 - attack) * running_max
    released = release * frame_peak + (1.0 - release) * running_max
    new_max = torch.where(frame_peak > running_max, attacked, released)
    norm_factor = torch.clamp(sigmoid_normalize(frame_peak, new_max),
                              0.0, 1.0)
    out = signal / (frame_peak / norm_factor)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out, new_max


def overlap_add(signal, ola_tail, window):
    """Peak-normalize, window and overlap-add one frame
    (SoundEngine.swift:231-254); the peak is global across channels.
    Returns (out_hop [..., nfft//2], new_tail [..., nfft])."""
    hop = signal.shape[-1] // 2
    gain = 1.0 / (torch.amax(torch.abs(signal)) + 1e-6)
    windowed = signal * gain * window
    return ola_tail[..., hop:] + windowed[..., :hop], windowed
