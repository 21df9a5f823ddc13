"""Display-space math behind the reference's visualization views, as data
— the PyTorch port's copy of :mod:`vaudio.utils.display`.

The reference ships three math-heavy UI surfaces (SURVEY.md §2.12-2.13):
``SpectrumView`` (log-frequency dB spectrum), ``TimeDomainFrameView``
(waveform polyline) and ``VisualizePeak`` (the interactive Hann-sinc x
Lorentzian peak-shape explorer documenting the synthesis peak formula).
Their *capability* is the mapping from DSP state to plottable curves; these
functions return exactly those curves so any frontend (notebook, TUI, web)
can render them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import hann_sinc_peak


def spectrum_display(spectrum: np.ndarray, cfg: AuralizerConfig,
                     f_min: float = 20.0, f_max: float = 20000.0,
                     db_floor: float = -60.0, db_ceil: float = 5.0
                     ) -> Dict[str, np.ndarray]:
    """Log-frequency dB curve, normalized to the frame max — the
    SpectrumView mapping (Views/SpectrumView.swift:15-77).

    Args:
      spectrum: f32[F, 2] complex half-spectrum (re, im).
    Returns dict with 'freq_hz', 'log_x' (0..1 position), 'db',
    'norm_y' (0..1 height).
    """
    spectrum = np.asarray(spectrum)
    mag = np.hypot(spectrum[:, 0], spectrum[:, 1])
    freqs = cfg.bin_frequencies()
    sel = (freqs >= f_min) & (freqs <= f_max)
    mag = mag[sel]
    f = freqs[sel]
    db = 20.0 * np.log10(np.maximum(mag, 1e-12))
    ref = db.max() if db.size else 0.0
    db_rel = np.clip(db - ref, db_floor, db_ceil)
    return {
        "freq_hz": f,
        "log_x": np.log(f / f_min) / np.log(f_max / f_min),
        "db": db_rel,
        "norm_y": (db_rel - db_floor) / (db_ceil - db_floor),
    }


def peak_shape_curve(bandwidth: float = 1.0, q: Optional[float] = None,
                     span: float = 8.0, n: int = 513
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The synthesis peak shape W(d) over bin distance d — the VisualizePeak
    explorer's curve (Tools/VisualizePeak.swift:69,104-109: Hann-transform
    peak, optionally multiplied by a Lorentzian Q envelope).

    Returns (d, W(d/bandwidth) [* lorentzian]).
    """
    d = np.linspace(-span, span, n).astype(np.float32)
    w = hann_sinc_peak(torch.as_tensor(d / np.float32(bandwidth))).numpy()
    if q is not None:
        w = w / (1.0 + (d / q) ** 2)
    return d, w
