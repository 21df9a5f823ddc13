"""Typed configuration of the port — a copy of :mod:`vaudio.config`.

The port keeps its own copy so that it never imports the JAX package; the
two are held field for field, default for default, by
``tests/test_torch_config.py``.  The port's functions read a config by
attribute only, so the JAX package's ``AuralizerConfig`` works with them too.

* :class:`AuralizerConfig` — static configuration (shapes and constants).
* :class:`LiveParams` — the runtime-tunable parameters (the reference's
  ``@Published`` controls), re-read on every frame.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Inharmonic Bessel-mode frequency ratios (SoundEngine.swift:105-126,
# SpectrumCompute.metal:60-80).  The synthesis iterates the first 18, the
# phase accumulation advances all 19.
BESSEL_RATIOS: Tuple[float, ...] = (
    1.59334, 2.13555, 2.29542, 2.65307, 2.9173,
    3.15546, 3.50015, 3.64745, 4.05893, 4.13174,
    4.60104, 4.61005, 5.08357, 5.13077, 5.55313,
    5.65084, 6.01936, 6.16314, 6.48274,
)


@dataclasses.dataclass(frozen=True)
class AuralizerConfig:
    """Static configuration; the defaults reproduce the reference app's
    math and quirks (see :mod:`vaudio.config` for each field's history)."""

    # --- audio format (SoundEngine.swift:46-48) ---
    sample_rate: float = 44100.0
    video_fps: float = 30.0
    nfft: int = 4096

    # --- vision (VisionEngine.swift:24,194-195) ---
    mip_level: int = 3
    grid_size: int = 4          # 4x4 = 16 cells
    num_hue_bins: int = 360
    # Histogram gates (convolveFeatures.metal:154, VisionEngine.swift:263)
    saturation_gate: float = 0.0
    intensity_gate: float = 0.1
    hist_count_gate: int = 20

    # --- synthesis (SpectrumCompute.metal:82-214) ---
    num_harmonics: int = 13
    num_bessel_synth: int = 18      # the kernel iterates 18 of the 19 ratios
    f0_base: float = 220.0          # f0 = 220 * 2^(3*hue/360)
    f0_octaves: float = 3.0
    max_partial_freq: float = 20000.0
    narrowband_below: float = 200.0  # bandWidth=5 below 200 Hz else 1
    narrow_bandwidth: float = 5.0
    wide_bandwidth: float = 1.0

    # --- streaming runtime (SoundEngine.swift:88,171-175,448) ---
    ring_buffer_frames: int = 16
    warmup_frames: int = 3

    # --- output channels: 1 = mono (the reference), 2 = column-panned ---
    channels: int = 1

    # --- fidelity / quirk switches ---
    # Phase accumulators written with stride 32, read with stride 22
    # (SpectrumCompute.metal:135,179); False uses the clean layout.
    quirk_compat: bool = True
    # 8-bit quantization of every mip level (VisionEngine.swift:137-147).
    quantize_mips: bool = False
    # The quantized chain in all-integer arithmetic (round half to even).
    quantize_mips_int8: bool = False
    # Gradient cells are contiguous 1/16 slices of the rotated linear pixel
    # array (VisionEngine.swift:278-283); False uses the spatial 4x4 tiling.
    linear_cell_grads: bool = True
    # Kernel switches, named after the JAX package's Pallas kernels.  In the
    # port: use_pallas runs the fused AGC + overlap-add kernel (K4) in the
    # per-frame step, as does use_pallas_audio; use_pallas_pool is the mip
    # pool (K1, always the kernel on CUDA); use_pallas_vision runs the
    # fused vision epilogue (K3) for the shapes its ``supports`` accepts.
    use_pallas: bool = False
    use_pallas_audio: bool = False
    use_pallas_pool: bool = True
    use_pallas_vision: bool = False
    # The inverse FFT as two dense f32 matmuls.
    use_matmul_irfft: bool = False
    # The chunked spectrum EMA as one lower-triangular (T, T) matmul.
    use_matmul_ema: bool = False
    # The chunked phases as a mod-2pi prefix sum after the hue scan.
    use_cumsum_phases: bool = True
    # The hue arccos as a degree-7 sqrt-polynomial (A&S 4.4.46).
    fast_hue_acos: bool = True
    # The per-frame phase advance as a gather into a (360, P) table.
    use_phase_lut: bool = False
    # The reference's commented-out spectral HP/LP filter
    # (SpectrumCompute.metal:200-209); off reproduces the no-op sliders.
    enable_filters: bool = False

    # ------------------------------------------------------------------
    # Derived quantities (SoundEngine.swift:129-144)
    # ------------------------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def n(self) -> int:
        """Effective DFT length used for bin width: NFFT - 2 = 4094."""
        return self.nfft - 2

    @property
    def num_bins(self) -> int:
        """F — number of synthesized half-spectrum bins (2047)."""
        return max(2, self.n // 2)

    @property
    def hop_size(self) -> int:
        """Overlap-add hop (SoundEngine.swift:96)."""
        return self.nfft // 2

    @property
    def bin_width(self) -> float:
        """fs / N ≈ 10.772 Hz (SoundEngine.swift:143)."""
        return self.sample_rate / float(self.n)

    @property
    def num_bessel(self) -> int:
        return len(BESSEL_RATIOS)

    @property
    def phase_stride(self) -> int:
        """Stride of the phase-accumulation write layout: 13+19 = 32."""
        return self.num_harmonics + self.num_bessel

    @property
    def phase_read_stride(self) -> int:
        """Stride the synthesis reads with: 22 (= 13+9) in quirk-compat mode
        (SpectrumCompute.metal:135,179), otherwise the write stride."""
        return 22 if self.quirk_compat else self.phase_stride

    @property
    def num_phase_slots(self) -> int:
        return self.num_cells * self.phase_stride

    def bin_frequencies(self) -> np.ndarray:
        """The reference's bin-frequency grid, linspace(fs/F, fs/2 + fs/F,
        F) (SoundEngine.swift:141); the top bins slightly exceed Nyquist."""
        F = self.num_bins
        start = self.sample_rate / F
        end = self.sample_rate / 2 + self.sample_rate / F
        return np.linspace(start, end, F, dtype=np.float32)

    def bessel_ratios(self) -> np.ndarray:
        return np.asarray(BESSEL_RATIOS, dtype=np.float32)


@dataclasses.dataclass
class LiveParams:
    """Runtime-tunable parameters (SoundEngine.swift:66-75, plus the vision
    smoothing coefficient of VisionEngine.swift:36)."""

    attack: float = 1.0
    release: float = 1.0
    spectrum_mixing: float = 0.9
    hp_cutoff: float = 200.0
    lp_cutoff: float = 18000.0
    hp_order: float = 0.0
    lp_order: float = 0.0
    # Stereo width about centre: 1 = the column pan law, 0 = dual mono.
    stereo_width: float = 1.0
    # Optional per-cell pan angles in [0, pi/2] replacing the column law.
    pan_angles: object = None

    def as_arrays(self):
        """A dict of float32 numpy values: scalars as np.float32, arrays as
        f32 arrays; fields left at ``None`` are omitted."""
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            arr = np.asarray(value, dtype=np.float32)
            out[f.name] = arr if arr.ndim else np.float32(arr)
        return out


DEFAULT_CONFIG = AuralizerConfig()
