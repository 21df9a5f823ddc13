"""Spectral synthesis — the PyTorch port of :mod:`vaudio.synth`, exporting
the same names (see :mod:`.spectrum`)."""

from vaudio_torch.synth.spectrum import (
    SynthConstants,
    build_spectrum,
    cell_pan_gains,
    contract_spectrum,
    finalize_spectrum,
    flatten_partials,
    live_pan_from_params,
    live_pan_gains,
    partial_weights,
    phase_accumulate,
    phase_advance,
    spectral_filter_gain,
)

__all__ = [
    "SynthConstants",
    "build_spectrum",
    "cell_pan_gains",
    "contract_spectrum",
    "finalize_spectrum",
    "flatten_partials",
    "live_pan_from_params",
    "live_pan_gains",
    "partial_weights",
    "phase_accumulate",
    "phase_advance",
    "spectral_filter_gain",
]
