"""The f64 literal oracle of the reference's per-pixel and per-partial math
— the PyTorch port's own copy of the JAX package's test oracle
``tests/oracles.py``, so that the port's ``parity`` command and
:mod:`vaudio_torch.utils.parity` never import the JAX package's tests.

numpy only, float64, and literal: slow scalar loops that transcribe the
reference's Metal kernels and Swift reductions one pixel, bin and partial
at a time.  The loops are what keeps the oracle independent of the
vectorised code under test, so they stay loops.  Use small inputs, or a
few frames: one frame's spectrum is ~1M partial evaluations whatever the
frame size.
"""

import numpy as np


def rgb_to_hsi_scalar(r, g, b):
    """Literal transcription of convolveFeatures.metal:14-38 semantics."""
    i = (r + g + b) / 3.0
    min_val = min(r, g, b)
    s = (1.0 - min_val / i) if i > 0 else 0.0
    h = 0.0
    num = 0.5 * ((r - g) + (r - b))
    den = np.sqrt((r - g) ** 2 + (r - b) * (g - b))
    if den != 0.0:
        theta = np.arccos(np.clip(num / den, -1, 1))
        h = theta if b <= g else 2 * np.pi - theta
        h /= 2 * np.pi
    return h, s, i


def rgb_to_hsi_np(rgb):
    out = np.zeros_like(rgb, dtype=np.float64)
    flat_in = rgb.reshape(-1, 3)
    flat_out = out.reshape(-1, 3)
    for k in range(flat_in.shape[0]):
        flat_out[k] = rgb_to_hsi_scalar(*flat_in[k])
    return out


def mip_np(frame, level):
    x = frame.astype(np.float64)
    for _ in range(level):
        h, w = x.shape[0] // 2, x.shape[1] // 2
        x = x.reshape(h, 2, w, 2, -1).mean(axis=(1, 3)).reshape(h, w, -1)
    return x


MASKS = {
    # k[dy][dx] layouts from convolveFeatures.metal:94-113
    "breathing": np.array([[-1, 0, -1], [0, 4, 0], [-1, 0, -1]], float),
    "vtilt": np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], float),
    "htilt": np.array([[-1, -1, -1], [0, 0, 0], [1, 1, 1]], float),
    "saddle": np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], float),
}


def convolve_features_np(mip_rgb):
    """Literal convolveFeatures: returns rotated (Wm, Hm, 3, 4) maps."""
    hm, wm = mip_rgb.shape[:2]
    hsi = rgb_to_hsi_np(mip_rgb)
    out = np.zeros((wm, hm, 3, 4))
    masks = [MASKS["breathing"], MASKS["vtilt"], MASKS["htilt"],
             MASKS["saddle"]]
    for gy in range(hm):
        for gx in range(wm):
            rot_x = (hm - 1) - gy
            rot_y = gx
            for ch in range(3):
                for m, mask in enumerate(masks):
                    acc = 0.0
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            yy = min(max(gy + dy, 0), hm - 1)
                            xx = min(max(gx + dx, 0), wm - 1)
                            acc += mask[dy + 1, dx + 1] * hsi[yy, xx, ch]
                    out[rot_y, rot_x, ch, m] = acc
    return out


def hue_histogram_np(mip_rgb, grid=4, bins=360):
    """Literal calculateHueHistogram (convolveFeatures.metal:132-165)."""
    hm, wm = mip_rgb.shape[:2]
    hsi = rgb_to_hsi_np(mip_rgb)
    hist = np.zeros((grid * grid, bins), np.int64)
    for gy in range(hm):
        for gx in range(wm):
            rot_x = (hm - 1) - gy
            rot_y = gx
            h, s, i = hsi[gy, gx]
            if s > 0.0 and i > 0.1:
                col = (rot_x * grid) // hm
                row = (rot_y * grid) // wm
                cell = row * grid + col
                b = int(h * (bins - 1))
                hist[cell, min(b, bins - 1)] += 1
    return hist


def update_hues_np(hist, prev, mixing, gate=20):
    """Literal VisionEngine.swift:255-271.  The argmax loop transcribes
    Swift's ``max(by:)``, which replaces its running result whenever the
    candidate is NOT strictly less — so equal max counts resolve to the
    LAST (highest) bin."""
    out = prev.copy()
    for c in range(hist.shape[0]):
        mx = hist[c].max()
        if mx > gate:
            arg = 0
            for b in range(1, hist.shape[1]):
                if not (hist[c, b] < hist[c, arg]):
                    arg = b
            out[c] = np.int32(float(prev[c]) * mixing + arg * (1 - mixing))
    return out


def cell_grad_stats_np(intensity_rot):
    """Literal VisionEngine.swift:273-295 (linear-slice cells)."""
    flat = intensity_rot.reshape(-1, 4)
    p = flat.shape[0]
    per = p // 16
    out = np.zeros((16, 4))
    for c in range(16):
        start = c * per
        end = p if c == 15 else start + per
        sl = flat[start:end]
        n = end - start
        out[c] = [np.sqrt(np.sum(sl[:, 0] ** 2) / n),
                  np.mean(np.abs(sl[:, 1])),
                  np.mean(np.abs(sl[:, 2])),
                  np.max(np.abs(sl[:, 3]))]
    return out


# ---------------------------------------------------------------------------
# Synthesis oracle (SpectrumCompute.metal:82-214 + SoundEngine.swift:257-286)
# ---------------------------------------------------------------------------

BESSEL = np.array([
    1.59334, 2.13555, 2.29542, 2.65307, 2.9173, 3.15546, 3.50015, 3.64745,
    4.05893, 4.13174, 4.60104, 4.61005, 5.08357, 5.13077, 5.55313, 5.65084,
    6.01936, 6.16314, 6.48274], np.float64)


def find_closest_index_np(freqs, target):
    lo, hi = 0, len(freqs) - 1
    while lo <= hi:
        mid = lo + (hi - lo) // 2
        if freqs[mid] < target:
            lo = mid + 1
        elif freqs[mid] > target:
            hi = mid - 1
        else:
            return mid
    if lo >= len(freqs):
        return len(freqs) - 1
    if lo <= 0:
        return 0
    return lo if abs(freqs[lo] - target) < abs(freqs[lo - 1] - target) \
        else lo - 1


def sinc_np(x):
    return 1.0 if x == 0 else np.sin(np.pi * x) / (np.pi * x)


def hann_peak_np(d):
    return 0.5 * sinc_np(d) - 0.25 * (sinc_np(d - 1) + sinc_np(d + 1))


def hash01(x):
    s = np.sin(x) * 43758.5453
    return s - np.floor(s)


def compute_spectrum_np(hues, grads, freqs, prev_spec, phase_accum,
                        spectrum_mixing, bin_width,
                        quirk_stride=22, quirk_bessel_offset=0):
    """Literal per-bin/per-cell/per-partial transcription of the
    computeSpectrum kernel (SpectrumCompute.metal:82-214).

    prev_spec, returns: complex arrays of length F.
    """
    F = len(freqs)
    out = np.zeros(F, np.complex128)
    for f_idx in range(F):
        bin_freq = freqs[f_idx]
        frame_sum = 0j
        hann_mult = 1.0 / bin_width
        random_phase = hash01(f_idx * 12.9898) * 2 * np.pi
        static_vec = complex(np.cos(random_phase), np.sin(random_phase))

        for cell in range(16):
            hue = int(hues[cell])
            if hue < 0 or hue > 360:
                continue
            f0_raw = 220.0 * 2.0 ** (hue / 360.0 * 3.0)
            f0 = freqs[find_closest_index_np(freqs, f0_raw)]
            bw = 5.0 if f0 < 200.0 else 1.0
            breathing, vtilt, htilt, saddle = grads[cell]
            cell_accum = 0j
            total_gain = 0.0
            roll = 4.0 + (0.5 - 4.0) * np.clip(breathing * 5.0, 0, 1)

            for h in range(1, 14):
                h_freq = f0 * h
                if h_freq > 20000.0:
                    break
                seed = cell * 1.618 + h * 13.13
                vel = phase_accum[cell * quirk_stride + (h - 1)]
                phase = hash01(seed) * 2 * np.pi + vel
                pvec = complex(np.cos(phase), np.sin(phase))
                gain = h ** (-roll)
                total_gain += gain
                if h > 1:
                    gain *= vtilt if h % 2 == 0 else htilt
                d = (bin_freq - h_freq) * hann_mult / bw
                cell_accum += pvec * hann_peak_np(d) * gain

            for b in range(18):
                b_freq = f0 * BESSEL[b]
                if b_freq > 20000.0:
                    break
                seed = cell * 1.618 + b * 13.13
                vel = phase_accum[cell * quirk_stride + quirk_bessel_offset
                                  + b]
                phase = hash01(seed) * 2 * np.pi + vel
                pvec = complex(np.cos(phase), np.sin(phase))
                gain = np.clip(saddle, 0.0, 2.0) * BESSEL[b] ** (-roll)
                total_gain += gain
                d = (bin_freq - b_freq) * hann_mult / bw
                cell_accum += pvec * hann_peak_np(d) * gain

            comp = np.sqrt(f0 / 220.0)
            norm = 1.0 / max(total_gain, 0.001) * 0.0625
            frame_sum += cell_accum * norm * comp

        frame_sum *= static_vec
        out[f_idx] = prev_spec[f_idx] * spectrum_mixing \
            + frame_sum * (1.0 - spectrum_mixing)
    return out


def phase_accumulate_np(phase_accum, hues, freqs, hop, fs,
                        write_stride=32, bessel_write_offset=13):
    """Literal SoundEngine.swift:257-286."""
    pa = phase_accum.copy()
    for cell in range(16):
        f0_raw = 220.0 * 2.0 ** (float(hues[cell]) / 360.0 * 3.0)
        f0 = freqs[find_closest_index_np(freqs, f0_raw)]
        for h in range(1, 14):
            idx = cell * write_stride + (h - 1)
            adv = 2 * np.pi * (f0 * h) * hop / fs
            pa[idx] = np.fmod(pa[idx] + adv, 2 * np.pi)
        for b in range(19):
            idx = cell * write_stride + bessel_write_offset + b
            adv = 2 * np.pi * (f0 * BESSEL[b]) * hop / fs
            pa[idx] = np.fmod(pa[idx] + adv, 2 * np.pi)
    return pa
