"""OrthoModes, the per-pixel model family — the PyTorch port of
:mod:`vaudio.models.orthomodes`.

One oscillator per mip pixel: amplitude from intensity plus the four
orthogonal-mode corrections, resonance Q from saturation, f0 from hue
mapped linearly to 400-790 Hz (computeOrthogonalModes.metal:45-149); each
oscillator is stamped as one Hann x Lorentzian peak onto the main model's
F-bin grid (VisualizePeak.swift:104-109) and the frames share the
irfft / AGC / overlap-add audio tail.

On the card a u8 clip pools through kernel K1's interleaved entry
(:func:`ops.pool_kernel.mip_pool`, one launch for a chunk of frames) and
the audio tail is kernel K4 in the frame order
(:func:`ops.audio_kernel.agc_overlap_add_frames`, one launch for a chunk;
a single frame is a chunk of one); the
Hann x Lorentzian contraction is plain PyTorch, as the JAX package leaves
it to XLA outside any Pallas kernel.  A chunk step runs the serial phase
recurrence and spectrum EMA frame by frame and evaluates the (F, P) peak
matrices in blocks of frames whose temporaries stay under
``_PEAK_BLOCK_BYTES`` each.

Two differences from the jitted JAX scan are bounded, not removed
(ROADMAP queue 3): XLA's ``arccos`` (an ``atan2`` of its own) and
``torch.acos`` differ by up to 2 ulp, and XLA:CPU contracts several
multiply-adds of the scan into FMAs.  The one on the phase recurrence,
where an error would grow frame by frame, is reproduced exactly
(:func:`advance_phases`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import (hann_sinc_peak_fast, hann_window_norm,
                                   irfft_from_half)
from vaudio_torch.ops import pool_kernel
from vaudio_torch.ops.audio_kernel import agc_overlap_add_frames
from vaudio_torch.vision.features import mip_downsample_planes

_TWO_PI = float(np.float32(2.0 * np.pi))
_EPS = float(np.float32(1e-6))
# Each (T_block, F, P) f32 temporary of the peak evaluation stays under
# this: 16 frames of 1080p at mip 5 (F x P x 4 = 16.2 MB a frame).
_PEAK_BLOCK_BYTES = 256 << 20
# sonify runs the chunk step over blocks of this many frames.
_SONIFY_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class OrthoModesConfig:
    """Static configuration of the per-pixel model; ``mip_level`` sets the
    oscillator count (one per mip pixel: level 5 puts 1080p at 33 x 60 =
    1980)."""

    audio: AuralizerConfig = dataclasses.field(
        default_factory=AuralizerConfig)
    mip_level: int = 5
    # f0 = 390 / (2 pi) * hue_radians + 400 (computeOrthogonalModes.metal:81)
    f0_offset: float = 400.0
    f0_span: float = 390.0
    # Q in [0, 1] -> Lorentzian lambda in [lo, hi]; a larger lambda is a
    # narrower resonance.
    lorentz_lo: float = 2.0
    lorentz_hi: float = 24.0
    bandwidth: float = 2.0          # Hann lobe width in bins

    @property
    def num_bins(self) -> int:
        return self.audio.num_bins


@dataclasses.dataclass
class ModeMultipliers:
    """The kernel's ``ModeMultipliers`` uniform
    (computeOrthogonalModes.metal:6-11), live-tunable mode weights."""

    breathing: float = 0.5
    vertical_tilt: float = 0.5
    horizontal_tilt: float = 0.5
    shear: float = 0.5

    def as_arrays(self):
        return {f.name: np.float32(getattr(self, f.name))
                for f in dataclasses.fields(self)}


class OrthoCarry(NamedTuple):
    """The recurrent state of one OrthoModes stream."""

    phases: torch.Tensor         # f32[P] per-oscillator phase accumulators
    prev_spectrum: torch.Tensor  # f32[F, 2]
    ola_tail: torch.Tensor       # f32[nfft]
    running_max: torch.Tensor    # f32[]


def carry_from_numpy(carry, device=None) -> OrthoCarry:
    """An :class:`OrthoCarry` on ``device`` (:func:`vaudio_torch.device`:
    the card unless given) from tensors or numpy-convertible fields: a
    dict, an ``.npz``, or a NamedTuple such as the JAX package's
    ``OrthoCarry``.  Host arrays are copied, never shared."""
    device = pick_device(device)
    fields = carry._asdict() if hasattr(carry, "_asdict") else carry
    return OrthoCarry(**{
        name: (fields[name].to(device) if isinstance(fields[name],
                                                     torch.Tensor)
               else torch.as_tensor(np.array(fields[name]), device=device))
        for name in OrthoCarry._fields})


def carry_to_numpy(carry: OrthoCarry) -> Dict[str, np.ndarray]:
    """The carry as a dict of numpy arrays (the JAX package's dtypes)."""
    return {name: getattr(carry, name).cpu().numpy()
            for name in OrthoCarry._fields}


def _hsi_kernel_variant(r, g, b):
    """The dead kernel's HSI variant (computeOrthogonalModes.metal:64-82):
    I = mean; S = (max - min) / max (HSV-style); H in radians.  Every
    division has tensor operands (a true division on the card too)."""
    i = (r + g + b) * float(np.float32(1.0 / 3.0))
    mn = torch.minimum(r, torch.minimum(g, b))
    mx = torch.maximum(r, torch.maximum(g, b))
    one, zero = torch.ones_like(i), torch.zeros_like(i)
    s = torch.where(i > _EPS, (mx - mn) / torch.where(mx > 0, mx, one), zero)

    num = 0.5 * ((r - g) + (r - b))
    rg = r - g
    den = torch.sqrt(rg * rg + (r - b) * (g - b))
    big = den > _EPS
    theta = torch.where(big, torch.acos(torch.clamp(
        num / torch.where(big, den, one), -1.0, 1.0)), zero)
    h = torch.where(b <= g, theta, _TWO_PI - theta)
    return i, s, h


def _neighbour_diffs(chan):
    """(d_n, d_s, d_e, d_w) of (..., hm, wm) planes: each clamp-to-edge
    neighbour (the kernel's sampler) less the centre, read from one
    edge-replicated copy."""
    hm, wm = chan.shape[-2:]
    padded = torch.nn.functional.pad(
        chan.reshape(-1, 1, hm, wm), (1, 1, 1, 1), mode="replicate"
    ).reshape(chan.shape[:-2] + (hm + 2, wm + 2))
    return (padded[..., :-2, 1:-1] - chan, padded[..., 2:, 1:-1] - chan,
            padded[..., 1:-1, 2:] - chan, padded[..., 1:-1, :-2] - chan)


def pixel_mip(frames, level: int):
    """RGB frames (..., H, W, 3), u8 or f32, -> f32 mips (..., 3, H >> l,
    W >> l) in [0, 1]: u8 frames at levels 1-7 through K1's interleaved
    entry, read in place; f32 frames (and other levels) through
    :func:`vision.features.mip_downsample_planes`, as the JAX package."""
    lead = frames.shape[:-3]
    batch = frames.reshape((-1,) + tuple(frames.shape[-3:]))
    if batch.dtype == torch.uint8 and 1 <= level <= 7:
        mip = pool_kernel.mip_pool(batch.contiguous(), level,
                                   scale=1.0 / 255.0)
    else:
        scale = 1.0 / 255.0 if batch.dtype == torch.uint8 else 1.0
        mip = mip_downsample_planes(batch.permute(0, 3, 1, 2), level,
                                    scale=scale)
    return mip.reshape(lead + tuple(mip.shape[1:]))


def params_on(params: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's params (mode multipliers, spectrum_mixing, attack,
    release) as f32 tensors on ``device``."""
    return {k: (v.to(device=device, dtype=torch.float32)
                if isinstance(v, torch.Tensor)
                else torch.tensor(np.float32(v), device=device))
            for k, v in params.items()}


def extract_pixel_modes(frames, multipliers: Dict, cfg: OrthoModesConfig):
    """Per-pixel (A, Q, f0), the kernel body vectorised
    (computeOrthogonalModes.metal:45-149): a 5-point clamp-to-edge stencil
    over the mip's intensity and saturation, combined into four orthogonal
    modes weighted by the live multipliers:

      A  = max(0, 255 (I_c + sum_i I_Mi w_i))
      Q  = clamp(S_c + sum_i S_Mi w_i, 0, 1)
      f0 = 390 / (2 pi) hue + 400        (Hz, from the centre pixel)

    ``frames``: RGB (H, W, 3) or a batch (T, H, W, 3), u8 or f32.  Returns
    (amp, q, f0), each f32[P] or f32[T, P], P the mip's pixels.  With a
    stream axis, frames (S, T, H, W, 3) and multipliers f32[S], each
    stream's frames take its own multipliers: f32[S, T, P].
    """
    mip = pixel_mip(frames, cfg.mip_level)
    i, s, h = _hsi_kernel_variant(mip[..., 0, :, :], mip[..., 1, :, :],
                                  mip[..., 2, :, :])
    f0 = float(np.float32(cfg.f0_span / (2.0 * np.pi))) * h \
        + float(np.float32(cfg.f0_offset))

    inv_sqrt2 = float(np.float32(0.70710678))
    modes = {}
    for name, chan in (("i", i), ("s", s)):
        d_n, d_s, d_e, d_w = _neighbour_diffs(chan)
        modes[name] = (
            0.5 * (d_n + d_s + d_e + d_w),          # M1 breathing
            inv_sqrt2 * (d_n - d_s),                 # M2 vertical tilt
            inv_sqrt2 * (d_e - d_w),                 # M3 horizontal tilt
            0.5 * (d_n - d_e + d_s - d_w),           # M4 shear
        )

    names = ("breathing", "vertical_tilt", "horizontal_tilt", "shear")
    mults = params_on({k: multipliers[k] for k in names}, mip.device)
    w = [mults[k] for k in names]
    if w[0].dim() == 1:         # a stream axis: each stream's multipliers
        w = [x.reshape((-1,) + (1,) * (i.dim() - 1)) for x in w]
    im1, im2, im3, im4 = modes["i"]
    sm1, sm2, sm3, sm4 = modes["s"]
    amp = torch.clamp(255.0 * (i + im1 * w[0] + im2 * w[1] + im3 * w[2]
                               + im4 * w[3]), min=0.0)
    q = torch.clamp(s + sm1 * w[0] + sm2 * w[1] + sm3 * w[2] + sm4 * w[3],
                    0.0, 1.0)
    flat = mip.shape[:-3] + (-1,)
    return amp.reshape(flat), q.reshape(flat), f0.reshape(flat)


def advance_phases(phases, f0, acfg: AuralizerConfig):
    """One frame's phase recurrence, ``mod(phases + c f0, 2 pi)`` with c =
    2 pi hop / fs (f0 is continuous: the dead design predates bin
    snapping).  XLA:CPU contracts ``phases + c f0`` into one fused
    multiply-add (the compiled scan fuses the multiply and the add); the
    product and sum in f64 of f32 operands are exact, so the one rounding
    to f32 is the FMA's."""
    c = float(np.float32(2.0 * np.pi * acfg.hop_size / acfg.sample_rate))
    fused = (c * f0.double() + phases.double()).to(torch.float32)
    return torch.remainder(fused, _TWO_PI)


def peak_spectra(amp, q, f0, phases, cfg: OrthoModesConfig, consts: Dict):
    """The rotated spectra of a block of frames before the EMA: one
    Hann x Lorentzian peak per oscillator on the bin grid, contracted with
    its complex weight.  amp, q, f0, phases f32[T, P] -> f32[T, F, 2]; the
    (T, F, P) peak matrix is the block's footprint."""
    one = torch.ones((), device=amp.device)
    lam = float(np.float32(cfg.lorentz_lo)) + q * float(
        np.float32(cfg.lorentz_hi - cfg.lorentz_lo))            # (T, P)
    d = (consts["freqs"][:, None] - f0[:, None, :]) * consts["inv_bw"]
    lobe = hann_sinc_peak_fast(d) * 2.0                         # 1 at d = 0
    ld = lam[:, None, :] * d
    peak = lobe * (one / (one + ld * ld))                       # (T, F, P)

    phase = consts["seed_phase"] + phases
    norm = consts["norm"] * amp
    w = torch.stack([norm * torch.cos(phase), norm * torch.sin(phase)],
                    dim=-1)                                     # (T, P, 2)
    cur = torch.matmul(peak, w)                  # f32, TF32 off at import
    c, s = consts["static_cos"], consts["static_sin"]
    return torch.stack([cur[..., 0] * c - cur[..., 1] * s,
                        cur[..., 0] * s + cur[..., 1] * c], dim=-1)


def synthesize_spectrum(amp, q, f0, phases, prev_spectrum, mixing,
                        cfg: OrthoModesConfig, consts: Dict):
    """One frame's spectrum f32[F, 2]: the peaks of :func:`peak_spectra`
    and the spectrum EMA, ``prev m + rot (1 - m)``."""
    rot = peak_spectra(amp[None], q[None], f0[None], phases[None], cfg,
                       consts)[0]
    return prev_spectrum * mixing + rot * (1.0 - mixing)


class OrthoModesModel:
    """The per-pixel A/Q/f0 synthesis model (second model family), on one
    device (the card unless ``"cpu"`` is asked for).

    Usage::

        model = OrthoModesModel(OrthoModesConfig())
        audio = model.sonify(frames)            # f32[T*hop] numpy
    """

    def __init__(self, cfg: OrthoModesConfig = OrthoModesConfig(),
                 multipliers: ModeMultipliers | None = None, device=None):
        self.cfg = cfg
        self.multipliers = multipliers or ModeMultipliers()
        self.device = pick_device(device)
        self.window = torch.as_tensor(hann_window_norm(cfg.audio.nfft),
                                      device=self.device)
        self._consts_cache: Dict[int, Dict] = {}

    def _consts(self, p: int) -> Dict:
        """The host-side constants for P oscillators (the hash phases in
        f64, cast to f32 once), as tensors on the model's device."""
        if p not in self._consts_cache:
            acfg = self.cfg.audio
            fi = np.arange(acfg.num_bins, dtype=np.float64)
            sp = (lambda x: x - np.floor(x))(np.sin(fi * 12.9898)
                                             * 43758.5453) * 2 * np.pi
            pi_ = np.arange(p, dtype=np.float64)
            seed = (lambda x: x - np.floor(x))(np.sin(pi_ * 78.233)
                                               * 43758.5453) * 2 * np.pi
            dev = self.device
            self._consts_cache[p] = {
                "freqs": torch.as_tensor(acfg.bin_frequencies(), device=dev),
                "static_cos": torch.as_tensor(np.cos(sp).astype(np.float32),
                                              device=dev),
                "static_sin": torch.as_tensor(np.sin(sp).astype(np.float32),
                                              device=dev),
                "seed_phase": torch.as_tensor(seed.astype(np.float32),
                                              device=dev),
                # Host f32 scalars in the JAX op order.
                "inv_bw": float(np.float32(
                    1.0 / (acfg.bin_width * self.cfg.bandwidth))),
                "norm": float(np.float32(1.0 / 255.0)
                              / np.float32(max(p, 1))),
            }
        return self._consts_cache[p]

    def init_carry(self, p: int) -> OrthoCarry:
        acfg = self.cfg.audio
        f32 = dict(dtype=torch.float32, device=self.device)
        return OrthoCarry(
            phases=torch.zeros((p,), **f32),
            prev_spectrum=torch.zeros((acfg.num_bins, 2), **f32),
            ola_tail=torch.zeros((acfg.nfft,), **f32),
            running_max=torch.tensor(1.0, **f32))

    def num_oscillators(self, h: int, w: int) -> int:
        return (h >> self.cfg.mip_level) * (w >> self.cfg.mip_level)

    def default_params(self) -> Dict[str, np.float32]:
        """The params ``sonify`` takes when given none
        (vaudio/models/orthomodes.py:277-281)."""
        return {**self.multipliers.as_arrays(),
                "spectrum_mixing": np.float32(0.9),
                "attack": np.float32(1.0), "release": np.float32(1.0)}

    def _frames(self, frames):
        frames = frames if isinstance(frames, torch.Tensor) \
            else torch.as_tensor(np.asarray(frames))
        if frames.dtype != torch.uint8:
            frames = frames.to(torch.float32)
        return frames.to(self.device)

    def _spectra(self, carry: OrthoCarry, frames, params):
        """The frames' phases and spectra: (phases f32[P], spectra
        f32[T, F, 2]).  All T frames pool in one call; the phase recurrence
        and the EMA run frame by frame; the peaks in blocks of frames.

        With a stream axis (carry phases f32[S, P], frames (S, T, H, W,
        3), params f32[S]) all S·T frames pool in one call, the recurrence
        and the EMA step [S, ...] frame by frame with each stream's own
        mixing, and the peak blocks count S·T frames: (phases f32[S, P],
        spectra f32[S, T, F, 2])."""
        amp, q, f0 = extract_pixel_modes(frames, params, self.cfg)
        pod = carry.phases.dim() == 2
        lead, P = f0.shape[:-1], f0.shape[-1]
        consts = self._consts(P)
        # Time leads in the serial loops: (T, [S,] P).
        f0_t = f0.transpose(0, 1) if pod else f0
        T = f0_t.shape[0]
        phases, seq = carry.phases, []
        for t in range(T):
            phases = advance_phases(phases, f0_t[t], self.cfg.audio)
            seq.append(phases)
        seq = torch.stack(seq, dim=1 if pod else 0)     # like f0
        n = f0.numel() // P                             # S·T frames
        amp, q, f0, seq = (x.reshape(n, P) for x in (amp, q, f0, seq))
        block = max(1, _PEAK_BLOCK_BYTES // (self.cfg.num_bins * P * 4))
        rot = torch.cat([peak_spectra(amp[k:k + block], q[k:k + block],
                                      f0[k:k + block], seq[k:k + block],
                                      self.cfg, consts)
                         for k in range(0, n, block)])
        rot = rot.reshape(lead + rot.shape[1:])
        mixing = params["spectrum_mixing"]
        if pod:
            rot, mixing = rot.transpose(0, 1), mixing[:, None, None]
        new = rot * (1.0 - mixing)
        prev, spectra = carry.prev_spectrum, []
        for t in range(T):
            prev = prev * mixing + new[t]
            spectra.append(prev)
        return phases, torch.stack(spectra, dim=1 if pod else 0)

    def frame_step(self, carry: OrthoCarry, frame, params,
                   window=None) -> Tuple[OrthoCarry, torch.Tensor]:
        """One RGB frame (H, W, 3) in, one hop of mono PCM f32[hop] out:
        the chunk step on a chunk of one frame.  With a stream axis (see
        :meth:`chunk_step`) one frame of each of S streams (S, H, W, 3) in,
        pcm f32[S, hop] out."""
        pod = carry.phases.dim() == 2
        frames = self._frames(frame)
        carry, pcm, _ = self.chunk_step(
            carry, frames[:, None] if pod else frames[None], params, window)
        return carry, pcm[:, 0] if pod else pcm[0]

    def chunk_step(self, carry: OrthoCarry, frames, params, window=None):
        """T frames (T, H, W, 3) in, PCM f32[T, hop] out, equal to T
        chained :meth:`frame_step` calls: one K1 launch for the chunk's
        mips, one batched irfft and one K4 launch in the frame order.
        Returns (carry, pcm, spectra f32[T, F, 2]).

        With a leading stream axis — a carry whose fields lead with S,
        frames (S, T, H, W, 3) and params whose values lead with S
        (``runtime.multistream``) — the S streams run as one batch (one K1
        launch for the S·T frames, K4 with its stream axis) and every
        result leads with S."""
        params = params_on(params, self.device)
        window = self.window if window is None else window
        phases, spectra = self._spectra(carry, self._frames(frames), params)
        pcm, ola_tail, running_max = agc_overlap_add_frames(
            irfft_from_half(spectra), carry.ola_tail, window,
            carry.running_max, params["attack"], params["release"])
        last = spectra[:, -1] if carry.phases.dim() == 2 else spectra[-1]
        return OrthoCarry(phases, last, ola_tail, running_max), pcm, spectra

    def sonify(self, frames, params: Dict | None = None) -> np.ndarray:
        """Offline over a clip (T, H, W, 3), through the chunk step in
        blocks of ``_SONIFY_BLOCK`` frames; returns f32[T*hop] PCM as
        numpy."""
        T, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        if params is None:
            params = self.default_params()
        carry = self.init_carry(self.num_oscillators(h, w))
        pcm = []
        for start in range(0, T, _SONIFY_BLOCK):
            carry, out, _ = self.chunk_step(
                carry, frames[start:start + _SONIFY_BLOCK], params)
            pcm.append(out)
        return torch.cat(pcm).reshape(-1).cpu().numpy()
