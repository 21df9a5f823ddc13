"""Kernel K2: the batched Hann-peak spectrum contraction.

``out[t, f, k] = sum_p W((freqs[f] - pf[t, p]) * scale[t, p]) * w[t, p, k]``
with W = :func:`vaudio_torch.dsp.core.hann_sinc_peak_fast`.  It replaces
the TPU kernels ``vaudio/ops/spectrum_kernel.py::hann_peak_weighted_sum_batched``
and, at T = 1, ``hann_peak_weighted_sum`` / ``spectrum_pallas``.  The CUDA
source is ``csrc/spectrum_kernel.cu``.

:func:`hann_peak_weighted_sum` routes by device: a CPU tensor runs
:func:`hann_peak_weighted_sum_plain`, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch

from vaudio_torch.dsp.core import hann_sinc_peak_fast
from vaudio_torch.ops import _build

#: Kernel launches so far (a run resets it to 0 and reads it after).
launches = 0


def hann_peak_weighted_sum_plain(freqs, pfreq, scale, weights):
    """The plain PyTorch version: the (T, F, NP) peak matrix, then a batched
    f32 matmul (TF32 is off, ``vaudio_torch/__init__``)."""
    d = (freqs[None, :, None] - pfreq[:, None, :]) * scale[:, None, :]
    return torch.matmul(hann_sinc_peak_fast(d), weights)


def hann_peak_weighted_sum(freqs, pfreq, scale, weights):
    """freqs f32[F], pfreq/scale f32[T, NP], weights f32[T, NP, K] ->
    f32[T, F, K]; K is 2 (mono) or 4 (stereo)."""
    if freqs.device.type == "cpu":
        return hann_peak_weighted_sum_plain(freqs, pfreq, scale, weights)
    _build.require_cuda(freqs, "hann_peak_weighted_sum")
    global launches
    T, NP = pfreq.shape
    K = weights.shape[-1]
    F = freqs.shape[0]
    for name, x, shape in (("freqs", freqs, (F,)), ("pfreq", pfreq, (T, NP)),
                           ("scale", scale, (T, NP)),
                           ("weights", weights, (T, NP, K))):
        if (x.device != freqs.device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"hann_peak_weighted_sum: {name} must be a contiguous f32 "
                f"tensor of shape {shape} on {freqs.device}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if K not in (2, 4) or NP > 1024:
        raise ValueError(f"hann_peak_weighted_sum: the kernel takes K in "
                         f"(2, 4) and NP <= 1024; got K={K}, NP={NP}")
    out = torch.empty((T, F, K), dtype=torch.float32, device=freqs.device)
    err = _build.lib().vaudio_hann_peak_weighted_sum(
        freqs.data_ptr(), pfreq.data_ptr(), scale.data_ptr(),
        weights.data_ptr(), out.data_ptr(), T, F, NP, K,
        _build.stream_ptr(freqs.device))
    _build.check(err, "hann_peak_weighted_sum")
    launches += 1
    return out
