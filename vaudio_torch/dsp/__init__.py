"""DSP primitives — the PyTorch port of :mod:`vaudio.dsp`, exporting the
same names (see :mod:`.core`)."""

from vaudio_torch.dsp.core import (
    agc_normalize,
    find_closest_index,
    hann_sinc_peak,
    hann_sinc_peak_fast,
    hann_window_norm,
    hash_phase,
    hue_to_f0,
    irfft_from_half,
    irfft_from_half_dense,
    linear_to_log2,
    linspace,
    mirror_and_conjugate,
    overlap_add,
    sigmoid_normalize,
    sinc,
    sinpi_reduced,
)

__all__ = [
    "agc_normalize",
    "find_closest_index",
    "hann_sinc_peak",
    "hann_sinc_peak_fast",
    "hann_window_norm",
    "hash_phase",
    "hue_to_f0",
    "irfft_from_half",
    "irfft_from_half_dense",
    "linear_to_log2",
    "linspace",
    "mirror_and_conjugate",
    "overlap_add",
    "sigmoid_normalize",
    "sinc",
    "sinpi_reduced",
]
