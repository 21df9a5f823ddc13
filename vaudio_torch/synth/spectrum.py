"""Additive harmonic + Bessel spectrum synthesis — the PyTorch port of
:mod:`vaudio.synth.spectrum`.

Every function takes any leading batch dimensions (the chunked pipeline
passes a leading ``T``), where the JAX package ``vmap``s a per-frame one.
The host constants are built by the same numpy code as the JAX package's.

The serving pod's stream axis (``runtime.multistream``) is one of those
leading dimensions, with params whose values lead with S (one row a
stream): the functions that read the live params broadcast each stream's
values to its own rows (:func:`live_pan_gains`,
:func:`filter_gain_from_params`, :func:`finalize_spectrum`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import BESSEL_RATIOS, AuralizerConfig
from vaudio_torch.dsp.core import find_closest_index, hue_to_f0
from vaudio_torch.ops.spectrum_kernel import hann_peak_weighted_sum

_TWO_PI = np.float64(2.0 * np.pi)


def _hash01(x: np.ndarray) -> np.ndarray:
    s = np.sin(x) * 43758.5453
    return s - np.floor(s)


@dataclasses.dataclass(frozen=True)
class SynthConstants:
    """Host-precomputed synthesis constants, as tensors on one device.

    The fields are those of :class:`vaudio.synth.SynthConstants`
    (SpectrumCompute.metal:97,134-136,178-180): the bin grid, the static
    per-bin phase rotation, the per-(cell, partial) hash phases and the
    phase-accumulator gather indices with the stride-22 read quirk.
    """

    freqs: torch.Tensor          # f32[F]
    static_cos: torch.Tensor     # f32[F]
    static_sin: torch.Tensor     # f32[F]
    seed_phase: torch.Tensor     # f32[16, P]
    read_idx: torch.Tensor       # i32[16, P]
    bessel_synth: torch.Tensor   # f32[num_bessel_synth]
    harmonic_numbers: torch.Tensor  # f32[13]

    @classmethod
    def create(cls, cfg: AuralizerConfig, device=None) -> "SynthConstants":
        """The same numpy construction as the JAX package (f64 hashes cast
        to f32 once), so the arrays are byte-equal to its constants; on
        ``device`` (:func:`vaudio_torch.device`: the card unless given)."""
        F = cfg.num_bins
        nc = cfg.num_cells
        nh = cfg.num_harmonics
        nb = cfg.num_bessel_synth

        f_idx = np.arange(F, dtype=np.float64)
        static_phase = _hash01(f_idx * 12.9898) * _TWO_PI

        cells = np.arange(nc, dtype=np.float64)[:, None]
        h = np.arange(1, nh + 1, dtype=np.float64)[None, :]
        b = np.arange(nb, dtype=np.float64)[None, :]
        seed_h = _hash01(cells * 1.618 + h * 13.13) * _TWO_PI
        seed_b = _hash01(cells * 1.618 + b * 13.13) * _TWO_PI

        rs = cfg.phase_read_stride
        cell_base = np.arange(nc, dtype=np.int64)[:, None] * rs
        idx_h = cell_base + np.arange(nh)[None, :]
        bessel_off = 0 if cfg.quirk_compat else nh
        idx_b = cell_base + bessel_off + np.arange(nb)[None, :]
        read_idx = np.concatenate([idx_h, idx_b], axis=1)
        if read_idx.max() >= cfg.num_phase_slots:
            raise ValueError(
                f"phase read index {int(read_idx.max())} exceeds "
                f"num_phase_slots {cfg.num_phase_slots} — inconsistent "
                "phase_read_stride / num_cells configuration")

        return cls.from_numpy(
            device=device,
            freqs=cfg.bin_frequencies(),
            static_cos=np.cos(static_phase).astype(np.float32),
            static_sin=np.sin(static_phase).astype(np.float32),
            seed_phase=np.concatenate([seed_h, seed_b],
                                      axis=1).astype(np.float32),
            read_idx=read_idx.astype(np.int32),
            bessel_synth=cfg.bessel_ratios()[:nb],
            harmonic_numbers=np.arange(1, nh + 1, dtype=np.float32),
        )

    @classmethod
    def from_numpy(cls, device=None, **arrays) -> "SynthConstants":
        """Constants from numpy arrays, e.g. the fields of the JAX
        package's ``SynthConstants`` (``dataclasses.asdict``), on
        ``device`` (:func:`vaudio_torch.device`: the card unless given)."""
        device = pick_device(device)
        return cls(**{f.name: torch.as_tensor(np.asarray(arrays[f.name]),
                                              device=device)
                      for f in dataclasses.fields(cls)})

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @property
    def num_partials(self) -> int:
        return self.seed_phase.shape[1]

    @functools.cached_property
    def table_bytes(self) -> bytes:
        """The bytes of the bin grid and the harmonic numbers, which with
        the Bessel ratios decide the phase advance table; read from the
        device once per object."""
        return (self.freqs.cpu().numpy().tobytes()
                + self.harmonic_numbers.cpu().numpy().tobytes())


# ---------------------------------------------------------------------------
# Phase accumulation (SoundEngine.swift:257-286)
# ---------------------------------------------------------------------------

def _advance_freqs(hues, cfg: AuralizerConfig, consts: SynthConstants):
    """(f32[..., 16, 32] partial frequencies of the phase slots, the f32
    advance factor 2 pi hop / fs)."""
    freqs = consts.freqs
    f0 = freqs[find_closest_index(
        freqs, hue_to_f0(hues, cfg.f0_base, cfg.f0_octaves))]
    ratios = torch.cat([
        consts.harmonic_numbers,
        torch.as_tensor(np.asarray(BESSEL_RATIOS, np.float32),
                        device=freqs.device),
    ])                                                       # (32,)
    return f0[..., None] * ratios, float(np.float32(
        2.0 * np.pi * cfg.hop_size / cfg.sample_rate))


#: The phase advance tables of use_phase_lut, keyed by what decides them.
_ADV_TABLES: dict = {}


def _phase_advance_table(cfg: AuralizerConfig, consts: SynthConstants):
    """(360, 32) raw phase advances, one row per hue bin: the direct
    advance of every hue the EMA can give, built once on the constants'
    device with the direct path's own ops, so a gather through it equals
    the direct computation there bit for bit (cfg.use_phase_lut).

    Keyed by the values that decide the table (f0_base, f0_octaves,
    hop_size, sample_rate, the bytes of the bin grid, harmonic numbers and
    Bessel ratios) and the device, never by the constants' identity
    (ADVICE.md:3)."""
    key = (cfg.f0_base, cfg.f0_octaves, cfg.hop_size, cfg.sample_rate,
           consts.table_bytes, BESSEL_RATIOS, str(consts.freqs.device))
    table = _ADV_TABLES.get(key)
    if table is None:
        hues = torch.arange(360, dtype=torch.int32,
                            device=consts.freqs.device)
        pfreq, factor = _advance_freqs(hues, cfg, consts)
        table = _ADV_TABLES[key] = factor * pfreq
    return table


def phase_advance(hues, cfg: AuralizerConfig, consts: SynthConstants):
    """Raw (pre-mod) per-frame phase advance of every partial slot:
    i32[..., 16] hues in [0, 360) -> f32[..., 16, 32]; with
    ``cfg.use_phase_lut`` a gather from :func:`_phase_advance_table`."""
    if cfg.use_phase_lut:
        return _phase_advance_table(cfg, consts)[hues.long()]
    pfreq, factor = _advance_freqs(hues, cfg, consts)
    return factor * pfreq


def phase_accumulate(phases, hues, cfg: AuralizerConfig,
                     consts: SynthConstants):
    """Advance every cell's partial phases by one frame, wrapped mod 2 pi
    (the clean stride-32 write layout).

    XLA:CPU contracts the JAX package's ``phases + factor * pfreq`` into
    one fused multiply-add (measured: its phases equal the FMA's bit for
    bit and differ from two roundings by 1 ulp of the ~5000 rad advance).
    The port computes that FMA exactly: the f64 product and sum of f32
    operands are exact, and the one rounding to f32 is the FMA's.  With
    ``cfg.use_phase_lut`` the JAX package adds a gathered table entry, a
    plain f32 add with no product to contract, and so does the port (its
    phases then differ from the default config's by up to an ulp of the
    advance).
    """
    two_pi = float(np.float32(2.0 * np.pi))
    if cfg.use_phase_lut:
        return torch.remainder(phases + phase_advance(hues, cfg, consts),
                               two_pi)
    pfreq, factor = _advance_freqs(hues, cfg, consts)
    fused = (factor * pfreq.double() + phases.double()).to(torch.float32)
    return torch.remainder(fused, two_pi)


# ---------------------------------------------------------------------------
# Spectrum synthesis
# ---------------------------------------------------------------------------

def partial_weights(hues, grads, phases, cfg: AuralizerConfig,
                    consts: SynthConstants, cell_slice=None):
    """Per-partial frequencies and complex weights (SpectrumCompute.metal
    :102-195): returns (pfreq f32[..., C, P], w_re, w_im, inv_bw f32[..., C])
    with gain, per-cell normalization, frequency compensation and validity
    folded into the weights.

    ``cell_slice=(start, count)`` restricts the computation to ``count``
    cells from ``start`` (the cell axis of ``parallel.sharding``'s
    tensor-parallel step): the hues, gradients, hash phases and gather
    indices are sliced, while ``phases`` stays whole, since the
    quirk-compat reads cross cell boundaries (stride 22 against 32)."""
    nh = cfg.num_harmonics
    freqs = consts.freqs
    seed_phase, read_idx = consts.seed_phase, consts.read_idx
    if cell_slice is not None:
        start, count = cell_slice
        cells = slice(start, start + count)
        hues, grads = hues[..., cells], grads[..., cells, :]
        seed_phase, read_idx = seed_phase[cells], read_idx[cells]

    valid = (hues >= 0) & (hues <= 360)
    f0 = freqs[find_closest_index(
        freqs, hue_to_f0(hues, cfg.f0_base, cfg.f0_octaves))]
    bw = torch.where(f0 < float(np.float32(cfg.narrowband_below)),
                     float(np.float32(cfg.narrow_bandwidth)),
                     float(np.float32(cfg.wide_bandwidth)))

    breathing, vtilt, htilt, saddle = grads.unbind(-1)

    # Roll-off: mix(4.0, 0.5, clamp(5 breathing, 0, 1)); nan-safe -> 2.0
    t = torch.clamp(breathing * 5.0, 0.0, 1.0)
    roll = 4.0 + (0.5 - 4.0) * t
    roll = torch.where(torch.isfinite(roll), roll, torch.full_like(roll, 2.0))

    hnum = consts.harmonic_numbers                           # (13,)
    bratio = consts.bessel_synth                             # (18,)
    ratios = torch.cat([hnum, bratio])                       # (P,)
    pfreq = f0[..., None] * ratios
    audible = pfreq <= float(np.float32(cfg.max_partial_freq))

    base_h = torch.pow(hnum, -roll[..., None])
    base_b = torch.clamp(saddle, 0.0, 2.0)[..., None] * \
        torch.pow(bratio, -roll[..., None])
    base = torch.cat([base_h, base_b], dim=-1) * audible

    # Total cell gain uses the PRE-tilt harmonic gain (metal :142).
    total_gain = torch.sum(base, dim=-1)

    h_int = hnum.to(torch.int32)
    tilt = torch.where(h_int % 2 == 0, vtilt[..., None], htilt[..., None])
    tilt = torch.where(h_int == 1, torch.ones_like(tilt), tilt)
    gain = torch.cat([base[..., :nh] * tilt, base[..., nh:]], dim=-1)

    # Phases: hash seed + accumulated velocity, read through the quirk.
    vel = phases.flatten(-2)[..., read_idx.long()]
    phase = seed_phase + vel

    comp = torch.sqrt(f0 / float(np.float32(cfg.f0_base)))
    norm = (1.0 / torch.clamp(total_gain, min=0.001)) \
        * float(np.float32(1.0 / cfg.num_cells)) * comp \
        * valid.to(torch.float32)

    w = gain * norm[..., None]
    return pfreq, w * torch.cos(phase), w * torch.sin(phase), 1.0 / bw


def cell_pan_angles(cfg: AuralizerConfig) -> np.ndarray:
    """Per-cell pan angle in [0, pi/2] by grid column (0 = hard left)."""
    cols = np.arange(cfg.num_cells) % cfg.grid_size
    return (cols / max(cfg.grid_size - 1, 1) * (np.pi / 2.0)
            ).astype(np.float32)


def cell_pan_gains(cfg: AuralizerConfig) -> np.ndarray:
    """Equal-power (gL, gR) per cell by grid column: f32[num_cells, 2]."""
    theta = cell_pan_angles(cfg)
    return np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)


def live_pan_gains(cfg: AuralizerConfig, stereo_width, angles=None,
                   device=None):
    """Width-scaled equal-power pan gains f32[num_cells, 2] on ``device``
    (:func:`vaudio_torch.device`: the card unless given):
    theta' = pi/4 + width (theta - pi/4), clipped to [0, pi/2].  A width
    f32[S] (a stream axis, with angles f32[S, num_cells] or none) gives
    f32[S, num_cells, 2]."""
    device = pick_device(device)
    if angles is None:
        theta = torch.as_tensor(cell_pan_angles(cfg), device=device)
    else:
        theta = torch.as_tensor(angles, dtype=torch.float32, device=device)
    quarter = float(np.float32(np.pi / 4.0))
    w = torch.as_tensor(stereo_width, dtype=torch.float32, device=device)
    if w.dim() == 1:
        w = w[:, None]
    eff = torch.clamp(quarter + w * (theta - quarter), 0.0,
                      float(np.float32(np.pi / 2.0)))
    return torch.stack([torch.cos(eff), torch.sin(eff)], dim=-1)


def live_pan_from_params(cfg: AuralizerConfig, params, device=None):
    """Pan gains from a params dict carrying ``stereo_width`` and/or
    ``pan_angles`` (on ``device``, as :func:`live_pan_gains`), else None
    (the static column pan law)."""
    if cfg.channels != 2 or params is None:
        return None
    angles = params.get("pan_angles")
    if "stereo_width" in params or angles is not None:
        width = params["stereo_width"] if "stereo_width" in params else 1.0
        return live_pan_gains(cfg, width, angles=angles, device=device)
    return None


def spectral_filter_gain(freqs, hp_cutoff, lp_cutoff, hp_order, lp_order):
    """The reference's commented-out HP/LP per-bin gain
    (SpectrumCompute.metal:200-209); pow(0, 0) == 1 as written."""
    gain = torch.ones_like(freqs)
    hp_term = 1.0 + torch.pow(torch.clamp(hp_cutoff - freqs, min=0.0),
                              hp_order)
    lp_term = 1.0 + torch.pow(torch.clamp(freqs - lp_cutoff, min=0.0),
                              lp_order)
    gain = torch.where(freqs <= hp_cutoff, gain / hp_term, gain)
    return torch.where(freqs >= lp_cutoff, gain / lp_term, gain)


def flatten_partials(pfreq, w_re, w_im, inv_bw, cfg: AuralizerConfig,
                     cell_slice=None, pan=None):
    """Flatten per-cell partials into contraction operands, folding the
    stereo pan into the weights (column order [L_re, L_im, R_re, R_im]);
    ``cell_slice=(start, count)`` slices the pan gains to the cells of
    :func:`partial_weights`' ``cell_slice``.

    Returns (flat_pf f32[..., NP], flat_w f32[..., NP, 2*channels],
    flat_ibw f32[..., NP]).
    """
    nc, P = pfreq.shape[-2:]
    lead = pfreq.shape[:-2]
    flat_pf = pfreq.reshape(lead + (nc * P,))
    flat_w = torch.stack([w_re.reshape(lead + (nc * P,)),
                          w_im.reshape(lead + (nc * P,))], dim=-1)
    flat_ibw = inv_bw[..., None].expand(lead + (nc, P)).reshape(
        lead + (nc * P,))
    if cfg.channels == 2:
        if pan is None:
            pan = torch.as_tensor(cell_pan_gains(cfg), device=pfreq.device)
        if cell_slice is not None:
            start, count = cell_slice
            pan = pan[..., start:start + count, :]
        pan_flat = torch.repeat_interleave(pan, P, dim=-2)  # ([S,] NP, 2)
        flat_w = (pan_flat[..., None] * flat_w[..., None, :]).reshape(
            lead + (nc * P, cfg.channels * 2))
    return flat_pf, flat_w, flat_ibw


def contract_spectrum(flat_pf, flat_w, flat_ibw, cfg: AuralizerConfig,
                      consts: SynthConstants):
    """Stamp every partial's Hann peak onto the F-bin grid:
    ``out[..., f, k] = sum_p W((freqs[f] - pf[p]) * scale[p]) w[p, k]``
    with scale = inv_bw / bin_width.  Returns f32[..., F, 2*channels].

    This is kernel K2 (``ops.spectrum_kernel``): on a CPU tensor its plain
    PyTorch version runs, on a CUDA tensor the CUDA kernel.
    """
    scale = flat_ibw * float(np.float32(1.0 / cfg.bin_width))
    lead = flat_pf.shape[:-1]
    out = hann_peak_weighted_sum(
        consts.freqs, flat_pf.reshape(-1, flat_pf.shape[-1]),
        scale.reshape(-1, scale.shape[-1]),
        flat_w.reshape((-1,) + flat_w.shape[-2:]))
    return out.reshape(lead + out.shape[1:])


def rotate_spectrum(cur, cfg: AuralizerConfig, consts: SynthConstants):
    """Static per-bin phase rotation (complex multiply, metal :198) of a
    raw contraction output f32[..., F, 2*channels]; stereo comes back as
    f32[..., 2, F, 2] (channel before bin)."""
    if cfg.channels == 2:
        cur = cur.reshape(cur.shape[:-1] + (cfg.channels, 2)) \
            .transpose(-3, -2)
    c = consts.static_cos
    s = consts.static_sin
    return torch.stack([cur[..., 0] * c - cur[..., 1] * s,
                        cur[..., 0] * s + cur[..., 1] * c], dim=-1)


def filter_gain_from_params(params, consts: SynthConstants,
                            channels: int = 1):
    """Per-bin HP/LP gain f32[F, 1] from the live params; with a stream
    axis (params f32[S]) f32[S, F, 1], or f32[S, 1, F, 1] against stereo
    spectra (``channels`` 2)."""
    keys = ("hp_cutoff", "lp_cutoff", "hp_order", "lp_order")
    if params["hp_cutoff"].dim() == 0:
        return spectral_filter_gain(consts.freqs,
                                    *(params[k] for k in keys))[:, None]
    gain = spectral_filter_gain(consts.freqs,
                                *(params[k][:, None] for k in keys))
    return gain[:, None, :, None] if channels == 2 else gain[..., None]


def finalize_spectrum(cur, prev_spectrum, spectrum_mixing,
                      cfg: AuralizerConfig, consts: SynthConstants,
                      filter_params=None):
    """Rotation, optional HP/LP filter and the temporal EMA against the
    previous frame (SpectrumCompute.metal:198-213); a mixing f32[S] (a
    stream axis) mixes each stream's rows with its own value."""
    rot = rotate_spectrum(cur, cfg, consts)
    if cfg.enable_filters and filter_params is not None:
        rot = rot * filter_gain_from_params(filter_params, consts,
                                            cfg.channels)
    m = _stream_rows(spectrum_mixing, prev_spectrum.dim())
    return prev_spectrum * m + rot * (1.0 - m)


def _stream_rows(x, ndim: int):
    """A live param against a tensor of ``ndim`` dimensions: a scalar as
    it is, a stream axis's f32[S] as f32[S, 1, ...] (one row a stream)."""
    return x.reshape((-1,) + (1,) * (ndim - 1)) if x.dim() == 1 else x


def build_spectrum(hues, grads, phases, prev_spectrum, spectrum_mixing,
                   cfg: AuralizerConfig, consts: SynthConstants,
                   filter_params=None):
    """Full spectrum synthesis for one frame (one ``computeSpectrum``
    dispatch, SpectrumCompute.metal:82-214).  Returns the spectrum shaped
    like ``prev_spectrum``: f32[F, 2] mono or f32[2, F, 2] stereo."""
    pfreq, w_re, w_im, inv_bw = partial_weights(hues, grads, phases, cfg,
                                                consts)
    flat_pf, flat_w, flat_ibw = flatten_partials(
        pfreq, w_re, w_im, inv_bw, cfg,
        pan=live_pan_from_params(cfg, filter_params, hues.device))
    cur = contract_spectrum(flat_pf, flat_w, flat_ibw, cfg, consts)
    return finalize_spectrum(cur, prev_spectrum, spectrum_mixing, cfg,
                             consts, filter_params=filter_params)
