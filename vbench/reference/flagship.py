"""The plain reference of the flagship model: frames in, stereo or mono PCM
out, in plain PyTorch and NumPy.

It follows the reference app's per-frame math (VisionEngine.swift,
convolveFeatures.metal, SpectrumCompute.metal, SoundEngine.swift), frame
after frame from a cold start, and shares no code with the program under
test.  Stateless stages run on blocks of frames on the given device; the
serial recurrences (the hue EMA, the phase accumulators, the spectrum EMA
and the AGC envelope) step one frame at a time.  Arithmetic is float32
except where noted:

* the Hann peak matrix is evaluated in float64 and rounded once;
* the matrix product of the contraction is float32 with TF32 off, or, for
  the control (``matmul="tf32"``), TF32: on a card with the tensor cores'
  TF32 mode, on the CPU by rounding each operand to TF32's 10-bit
  mantissa;
* the phase accumulators follow one of the two float32 definitions the
  project uses (``phase_sum``):

  - ``"frame"``: each frame ``phase = (phase + 2 pi hop / fs * f)`` rounded
    once to float32, then ``mod 2 pi`` (the per-frame step);
  - ``"advances"``: each frame's advance ``2 pi hop / fs * f`` rounded to
    float32 and reduced ``mod 2 pi``; the phase is their running sum
    ``mod 2 pi`` (the chunked offline path's prefix sum).

  Over hundreds of frames the two drift apart by up to ~6e-3 in PCM, the
  rounding of the ~5000 rad advance, which is why the traffic names the
  one its entry point uses.

The arccos of the hue is ``torch.arccos`` (the program's
``fast_hue_acos`` polynomial is within 2e-8 rad of it).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as nnf

#: The 19 Bessel-mode frequency ratios (SoundEngine.swift:105-126).  The
#: phase accumulators advance all 19; the synthesis uses the first
#: ``num_bessel_synth``.
BESSEL_RATIOS = (1.59334, 2.13555, 2.29542, 2.65307, 2.9173, 3.15546,
                 3.50015, 3.64745, 4.05893, 4.13174, 4.60104, 4.61005,
                 5.08357, 5.13077, 5.55313, 5.65084, 6.01936, 6.16314,
                 6.48274)
#: The stride the synthesis reads the phase accumulators with in the
#: reference app (SpectrumCompute.metal:135,179): 13 + 9.
QUIRK_READ_STRIDE = 22
#: The AGC's sigmoid steepness (HelperFunctions.swift:132-138).
SIGMOID_K = 2.0
PHASE_SUMS = ("frame", "advances")
MATMULS = ("float32", "tf32")

_F32 = np.float32
_TWO_PI_F32 = _F32(2.0 * np.pi)


def _hash01(x):
    s = np.sin(x) * 43758.5453
    return s - np.floor(s)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10-bit mantissa, as the
    tensor cores take their operands."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def snap_index(freqs: np.ndarray, target: float) -> int:
    """The bin nearest ``target`` on the ascending grid; on an exact
    midpoint the lower bin (HelperFunctions.swift:233-261)."""
    hi = int(np.searchsorted(freqs, target, side="left"))
    if hi <= 0:
        return 0
    if hi >= len(freqs):
        return len(freqs) - 1
    lo = hi - 1
    return hi if abs(freqs[hi] - target) < abs(freqs[lo] - target) else lo


def histogram_cells(hm: int, wm: int, grid: int, device) -> torch.Tensor:
    """Each mip pixel's histogram cell, from the kernel's rotated
    coordinates (convolveFeatures.metal:155-157): i64[hm, wm]."""
    y = torch.arange(hm, device=device)[:, None]
    x = torch.arange(wm, device=device)[None, :]
    return ((x * grid) // wm) * grid + ((hm - 1 - y) * grid) // hm


class FlagshipReference:
    """The flagship pipeline for one stream.

    ``auralizer`` is the configuration file's ``auralizer`` group, ``live``
    its ``live_params`` group.  :meth:`run` sonifies frames ``0..n-1`` of a
    stream from a cold start and returns PCM f32[n, hop, channels]."""

    def __init__(self, auralizer: Dict, live: Dict, device,
                 phase_sum: str = "frame", matmul: str = "float32"):
        if phase_sum not in PHASE_SUMS:
            raise ValueError(f"phase_sum must be one of {PHASE_SUMS}")
        if matmul not in MATMULS:
            raise ValueError(f"matmul must be one of {MATMULS}")
        a = dict(auralizer)
        for key, want in (("quantize_mips", False),
                          ("linear_cell_grads", True),
                          ("enable_filters", False)):
            if a[key] != want:
                raise ValueError(f"the reference implements {key}={want} "
                                 f"only; the configuration has {a[key]}")
        self.device = torch.device(device)
        self.phase_sum = phase_sum
        self.matmul = matmul
        self.fs = float(a["sample_rate"])
        self.nfft = int(a["nfft"])
        self.hop = self.nfft // 2
        self.level = int(a["mip_level"])
        self.grid = int(a["grid_size"])
        self.cells = self.grid * self.grid
        self.nbins = int(a["num_hue_bins"])
        self.sat_gate = float(a["saturation_gate"])
        self.int_gate = float(a["intensity_gate"])
        self.count_gate = _F32(a["hist_count_gate"])
        self.nh = int(a["num_harmonics"])
        self.nb = int(a["num_bessel_synth"])
        self.f0_base = float(a["f0_base"])
        self.f0_octaves = float(a["f0_octaves"])
        self.max_partial = float(a["max_partial_freq"])
        self.narrow_below = float(a["narrowband_below"])
        self.bandwidths = (float(a["narrow_bandwidth"]),
                           float(a["wide_bandwidth"]))
        self.channels = int(a["channels"])
        if self.channels not in (1, 2):
            raise ValueError("the reference takes 1 or 2 channels")
        self.attack = _F32(live["attack"])
        self.release = _F32(live["release"])
        self.mixing = _F32(live["spectrum_mixing"])
        self.width = live.get("stereo_width")

        n = self.nfft - 2
        self.F = max(2, n // 2)
        self.bin_width = self.fs / n
        self.freqs = np.linspace(self.fs / self.F,
                                 self.fs / 2 + self.fs / self.F, self.F,
                                 dtype=np.float32)
        dev = self.device
        self._freqs = torch.as_tensor(self.freqs, dtype=torch.float64,
                                      device=dev)
        # f0 of every hue the EMA can hold, snapped to the bin grid.
        hue = np.arange(361, dtype=np.float64)
        targets = self.f0_base * 2.0 ** (hue / 360.0 * self.f0_octaves)
        self.f0_of_hue = self.freqs[[snap_index(self.freqs, t)
                                     for t in targets]]
        # Phase slots: 13 harmonics then all 19 Bessel ratios per cell.
        self.slot_ratios = np.concatenate([
            np.arange(1, self.nh + 1, dtype=np.float32),
            np.asarray(BESSEL_RATIOS, np.float32)])
        self.stride = self.nh + len(BESSEL_RATIOS)
        read_stride = QUIRK_READ_STRIDE if a["quirk_compat"] else self.stride
        bessel_off = 0 if a["quirk_compat"] else self.nh
        base = np.arange(self.cells)[:, None] * read_stride
        self.read_idx = np.concatenate(
            [base + np.arange(self.nh)[None],
             base + bessel_off + np.arange(self.nb)[None]], axis=1)
        if self.read_idx.max() >= self.cells * self.stride:
            raise ValueError("phase read index past the accumulators")
        self.factor = _F32(2.0 * np.pi * self.hop / self.fs)
        cells64 = np.arange(self.cells, dtype=np.float64)[:, None]
        seed = np.concatenate([
            _hash01(cells64 * 1.618 + np.arange(1, self.nh + 1) * 13.13),
            _hash01(cells64 * 1.618 + np.arange(self.nb) * 13.13)],
            axis=1) * (2.0 * np.pi)
        self._seed = torch.as_tensor(seed.astype(np.float32), device=dev)
        static = _hash01(np.arange(self.F, dtype=np.float64) * 12.9898) \
            * (2.0 * np.pi)
        self._cos = torch.as_tensor(np.cos(static).astype(np.float32),
                                    device=dev)
        self._sin = torch.as_tensor(np.sin(static).astype(np.float32),
                                    device=dev)
        self._ratios = torch.as_tensor(np.concatenate([
            np.arange(1, self.nh + 1, dtype=np.float32),
            np.asarray(BESSEL_RATIOS[:self.nb], np.float32)]), device=dev)
        k = np.arange(self.nfft, dtype=np.float64)
        self._window = torch.as_tensor(
            (np.sqrt(2.0 / 3.0) * (1.0 - np.cos(2.0 * np.pi * k
                                                 / self.nfft))
             ).astype(np.float32), device=dev)
        self._pan = self._pan_gains()
        g0 = 1.0 / (1.0 + np.exp(-SIGMOID_K * (0.0 - 0.5)))
        g1 = 1.0 / (1.0 + np.exp(-SIGMOID_K * (1.0 - 0.5)))
        self._g0, self._gspan = _F32(g0), _F32(g1 - g0)

    # -- constants ---------------------------------------------------------

    def _pan_gains(self):
        """Equal-power (left, right) gains per cell by grid column, the
        live stereo width about the centre applied: f32[cells, 2]."""
        if self.channels == 1:
            return None
        cols = np.arange(self.cells) % self.grid
        theta = torch.as_tensor(
            (cols / max(self.grid - 1, 1) * (np.pi / 2.0)).astype(
                np.float32), device=self.device)
        if self.width is not None:
            quarter = float(_F32(np.pi / 4.0))
            theta = torch.clamp(quarter + float(_F32(self.width))
                                * (theta - quarter), 0.0,
                                float(_F32(np.pi / 2.0)))
        return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)

    # -- stateless stages, on a block of frames ----------------------------

    def vision(self, frames: torch.Tensor):
        """u8 frames (B, H, W, 3) -> (max count f32[B, cells], last argmax
        bin i64[B, cells], gradient statistics f32[B, cells, 4])."""
        B, H, W, _ = frames.shape
        k = 1 << self.level
        hm, wm = H >> self.level, W >> self.level
        blocks = frames[:, :hm * k, :wm * k].reshape(B, hm, k, wm, k, 3)
        sums = blocks.sum(dim=(2, 4), dtype=torch.int32)
        rgb = sums.to(torch.float32) / torch.tensor(
            255.0 * k * k, device=self.device)
        r, g, b = rgb.unbind(-1)
        # HSI (convolveFeatures.metal:14-38).
        i = (r + g + b) / torch.tensor(3.0, device=self.device)
        mn = torch.minimum(r, torch.minimum(g, b))
        pos = i > 0.0
        s = torch.where(pos, 1.0 - mn / torch.where(pos, i,
                                                    torch.ones_like(i)),
                        torch.zeros_like(i))
        num = 0.5 * ((r - g) + (r - b))
        den = torch.sqrt((r - g) * (r - g) + (r - b) * (g - b))
        nz = den != 0.0
        theta = torch.arccos(torch.clamp(
            num / torch.where(nz, den, torch.ones_like(den)), -1.0, 1.0))
        two_pi = torch.tensor(float(_TWO_PI_F32), device=self.device)
        h = torch.where(b <= g, theta, two_pi - theta) / two_pi
        h = torch.where(nz, h, torch.zeros_like(h))
        # Per-cell hue histogram of the gated pixels.
        gate = (s > self.sat_gate) & (i > self.int_gate)
        hbin = torch.clamp((h * float(self.nbins - 1)).to(torch.int64), 0,
                           self.nbins - 1)
        frame = torch.arange(B, device=self.device)[:, None, None]
        cell = histogram_cells(hm, wm, self.grid, self.device)
        flat = (frame * self.cells + cell) * self.nbins + hbin
        hist = torch.bincount(flat[gate], minlength=B * self.cells
                              * self.nbins).reshape(B, self.cells,
                                                    self.nbins)
        max_count = hist.amax(dim=-1).to(torch.float32)
        last_arg = self.nbins - 1 - torch.argmax(
            torch.flip(hist, dims=(-1,)), dim=-1)
        return max_count, last_arg, self._gradients(i)

    def _gradients(self, i: torch.Tensor):
        """The four 3x3 mode masks on the intensity plane, clamp to edge
        (convolveFeatures.metal:94-113), and per cell (RMS breathing,
        mean |vertical tilt|, mean |horizontal tilt|, max |saddle|) over
        contiguous 1/cells slices of the rotated pixel buffer
        (VisionEngine.swift:273-295)."""
        B, hm, wm = i.shape
        p = nnf.pad(i[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]

        def tap(dy, dx):
            return p[:, dy:dy + hm, dx:dx + wm]

        breathing = 4.0 * tap(1, 1) - (tap(0, 0) + tap(0, 2) + tap(2, 0)
                                       + tap(2, 2))
        vtilt = (tap(0, 0) + tap(1, 0) + tap(2, 0)) \
            - (tap(0, 2) + tap(1, 2) + tap(2, 2))
        htilt = (tap(2, 0) + tap(2, 1) + tap(2, 2)) \
            - (tap(0, 0) + tap(0, 1) + tap(0, 2))
        saddle = (tap(0, 0) + tap(2, 2)) - (tap(0, 2) + tap(2, 0))
        modes = torch.stack([breathing, vtilt, htilt, saddle], dim=1)
        flat = torch.rot90(modes, k=-1, dims=(-2, -1)).reshape(B, 4, -1)
        total = flat.shape[-1]
        per = total // self.cells
        stats = []
        for c in range(self.cells):
            sl = flat[..., c * per:total if c == self.cells - 1
                      else (c + 1) * per]
            n = float(sl.shape[-1])
            stats.append(torch.stack([
                torch.sqrt((sl[:, 0] * sl[:, 0]).sum(-1) / n),
                sl[:, 1].abs().sum(-1) / n,
                sl[:, 2].abs().sum(-1) / n,
                sl[:, 3].abs().amax(-1)], dim=-1))
        return torch.stack(stats, dim=1)

    def spectrum(self, hues: torch.Tensor, grads: torch.Tensor,
                 phase_read: torch.Tensor) -> torch.Tensor:
        """One frame's raw spectrum per channel (SpectrumCompute.metal
        :82-198, before the EMA): hues i64[B, cells], grads f32[B, cells,
        4], the phases as read f32[B, cells, P] -> f32[B, C, F, 2]."""
        dev = self.device
        f0 = torch.as_tensor(self.f0_of_hue, device=dev)[hues]
        bw = torch.where(f0 < float(_F32(self.narrow_below)),
                         self.bandwidths[0], self.bandwidths[1])
        breathing, vtilt, htilt, saddle = grads.unbind(-1)
        roll = 4.0 + (0.5 - 4.0) * torch.clamp(breathing * 5.0, 0.0, 1.0)
        roll = torch.where(torch.isfinite(roll), roll,
                           torch.full_like(roll, 2.0))
        hnum, brat = self._ratios[:self.nh], self._ratios[self.nh:]
        pf = f0[..., None] * self._ratios
        audible = (pf <= float(_F32(self.max_partial))).to(torch.float32)
        base = torch.cat([
            torch.pow(hnum, -roll[..., None]),
            torch.clamp(saddle, 0.0, 2.0)[..., None]
            * torch.pow(brat, -roll[..., None])], dim=-1) * audible
        total = base.sum(-1)
        h = torch.arange(1, self.nh + 1, device=dev)
        tilt = torch.where(h % 2 == 0, vtilt[..., None], htilt[..., None])
        tilt = torch.where(h == 1, torch.ones_like(tilt), tilt)
        gain = torch.cat([base[..., :self.nh] * tilt, base[..., self.nh:]],
                         dim=-1)
        phase = self._seed + phase_read
        comp = torch.sqrt(f0 / float(_F32(self.f0_base)))
        valid = ((hues >= 0) & (hues <= 360)).to(torch.float32)
        norm = 1.0 / torch.clamp(total, min=0.001) \
            * float(_F32(1.0 / self.cells)) * comp * valid
        w = gain * norm[..., None]
        w_re, w_im = w * torch.cos(phase), w * torch.sin(phase)
        B = hues.shape[0]
        cols = [w_re, w_im] if self.channels == 1 else [
            self._pan[:, ch, None] * x for ch in (0, 1) for x in (w_re,
                                                                  w_im)]
        weights = torch.stack(cols, dim=-1).reshape(B, -1, 2 * self.channels)
        # The Hann peak of every partial on the bin grid, in float64.
        d = (self._freqs[None, :, None] - pf.reshape(B, 1, -1).double()) \
            / (bw[..., None].expand(pf.shape).reshape(B, 1, -1).double()
               * self.bin_width)
        peaks = (0.5 * torch.special.sinc(d)
                 - 0.25 * (torch.special.sinc(d - 1.0)
                           + torch.special.sinc(d + 1.0))).float()
        raw = self._contract(peaks, weights)            # (B, F, 2C)
        raw = raw.reshape(B, self.F, self.channels, 2).transpose(1, 2)
        re, im = raw[..., 0], raw[..., 1]
        return torch.stack([re * self._cos - im * self._sin,
                            re * self._sin + im * self._cos], dim=-1)

    def _contract(self, peaks, weights):
        if self.matmul == "float32":
            with _tf32(self.device, False):
                return torch.matmul(peaks, weights)
        if self.device.type == "cuda":
            with _tf32(self.device, True):
                return torch.matmul(peaks, weights)
        with _tf32(self.device, False):
            return torch.matmul(tf32_round(peaks), tf32_round(weights))

    # -- the stream ----------------------------------------------------------

    def run(self, frames_of: Callable[[int, int], torch.Tensor], n: int,
            block: int = 16) -> torch.Tensor:
        """PCM f32[n, hop, channels] of frames 0..n-1; ``frames_of(a, b)``
        gives u8 frames a..b-1 (b - a, H, W, 3) on the device."""
        dev = self.device
        C = self.channels
        hues = np.zeros(self.cells, np.int32)
        phases = np.zeros(self.cells * self.stride, np.float32)
        acc = np.zeros(self.cells * self.stride, np.float64)
        prev = torch.zeros((C, self.F, 2), dtype=torch.float32, device=dev)
        tail = torch.zeros((C, self.nfft), dtype=torch.float32, device=dev)
        running_max = _F32(1.0)
        one_m = _F32(1.0) - self.mixing
        out = []
        for start in range(0, n, block):
            stop = min(n, start + block)
            max_count, last_arg, grads = self.vision(frames_of(start, stop))
            max_count = max_count.cpu().numpy()
            last_arg = last_arg.cpu().numpy().astype(np.float32)
            hue_rows, read_rows = [], []
            for t in range(stop - start):
                # The gated, truncating hue EMA (VisionEngine.swift:255-271).
                mixed = hues.astype(np.float32) * self.mixing \
                    + last_arg[t] * one_m
                hues = np.where(max_count[t] > self.count_gate,
                                mixed.astype(np.int32), hues)
                hues = hues.astype(np.int32)
                phases, acc = self._advance(phases, acc, hues)
                hue_rows.append(hues.copy())
                read_rows.append(phases[self.read_idx])
            raw = self.spectrum(
                torch.as_tensor(np.stack(hue_rows), device=dev).long(),
                grads, torch.as_tensor(np.stack(read_rows), device=dev))
            spectra = []
            for t in range(raw.shape[0]):
                prev = prev * float(self.mixing) + raw[t] * float(one_m)
                spectra.append(prev)
            spectra = torch.stack(spectra)              # (B, C, F, 2)
            half = torch.complex(spectra[..., 0], spectra[..., 1])
            signal = torch.fft.irfft(nnf.pad(half, (1, 1)), n=self.nfft)
            pcm, tail, running_max = self._audio(signal, tail, running_max)
            out.append(pcm)
        return torch.cat(out)

    def _advance(self, phases, acc, hues):
        """One frame of the phase accumulators (SoundEngine.swift:257-286)
        in the definition ``phase_sum`` names."""
        pf = self.f0_of_hue[hues][:, None] * self.slot_ratios  # f32 products
        pf = pf.reshape(-1)
        if self.phase_sum == "frame":
            exact = phases.astype(np.float64) \
                + np.float64(self.factor) * pf.astype(np.float64)
            return np.fmod(exact.astype(np.float32), _TWO_PI_F32), acc
        adv = np.fmod(self.factor * pf, _TWO_PI_F32)   # f32 product, exact mod
        acc = np.fmod(acc + adv.astype(np.float64), np.float64(_TWO_PI_F32))
        return acc.astype(np.float32), acc

    def _audio(self, signal, tail, running_max):
        """AGC (SoundEngine.swift:412-426) and the windowed overlap-add
        (SoundEngine.swift:231-254) of a block of frames f32[B, C, nfft];
        the peaks are over both channels."""
        peaks = signal.abs().amax(dim=(1, 2)) + float(_F32(1e-9))
        peaks_host = peaks.cpu().numpy()
        maxes = []
        rm = running_max
        for p in peaks_host:
            attacked = self.attack * p + (_F32(1.0) - self.attack) * rm
            released = self.release * p + (_F32(1.0) - self.release) * rm
            rm = _F32(attacked if p > rm else released)
            maxes.append(rm)
        new_max = torch.as_tensor(np.asarray(maxes, np.float32),
                                  device=self.device)
        g = 1.0 / (1.0 + torch.exp(-SIGMOID_K * (peaks / new_max - 0.5)))
        nf = torch.clamp((g - float(self._g0)) / float(self._gspan), 0.0,
                         1.0)
        normalized = signal / (peaks / nf)[:, None, None]
        normalized = torch.where(torch.isfinite(normalized), normalized,
                                 torch.zeros_like(normalized))
        gain = 1.0 / (normalized.abs().amax(dim=(1, 2))
                      + float(_F32(1e-6)))
        windowed = normalized * gain[:, None, None] * self._window
        before = torch.cat([tail[None], windowed[:-1]])
        pcm = before[..., self.hop:] + windowed[..., :self.hop]
        return pcm.transpose(1, 2), windowed[-1], rm


class _tf32:
    """Sets the card's TF32 mode for matrix products within a block."""

    def __init__(self, device: torch.device, on: bool):
        self.cuda = device.type == "cuda"
        self.on = on

    def __enter__(self):
        if self.cuda:
            self.was = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = self.was


REFERENCE = FlagshipReference
