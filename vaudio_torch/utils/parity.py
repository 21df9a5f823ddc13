"""The port held to the reference's own math in float64: the end-to-end
parity harness and the device audit of the kernels.

* :func:`reference_pipeline` chains the literal scalar-loop oracle
  (:mod:`vaudio_torch.utils.oracles`) into a whole frame -> audio
  pipeline: the port's copy of the JAX package's ``benchmarks/parity.py``
  reference.
* :func:`run_parity` runs the port on the same frames, per frame or in
  chunks, and holds hues, gradient statistics, spectra and PCM to that
  pipeline under the JAX harness's gates (``python -m vaudio_torch
  parity`` prints it).
* :func:`audit_stages` is the device's counterpart of the JAX package's
  ``benchmarks/tpu_parity.py``: each parity-critical stage on the device
  against an f64 host oracle, the TPU audit's stages and tolerances plus
  three for the GPU's own traps (the audio tail K4, the dense irfft and
  the matrix spectrum EMA, where TF32 left on would show).  On a CUDA
  device every kernel stage must launch its CUDA kernel.

Everything here runs on the device it is given; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp.core import (hann_sinc_peak_fast, hann_window_norm,
                                   irfft_from_half_dense)
from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                              vision_kernel)
from vaudio_torch.runtime.chunked import (_matmul_ema, associative_scan,
                                          run_offline_batched)
from vaudio_torch.runtime.step import init_carry, run_offline
from vaudio_torch.synth.spectrum import (SynthConstants, contract_spectrum,
                                         phase_accumulate, phase_advance)
from vaudio_torch.utils import oracles
from vaudio_torch.vision.features import (acos_fdlibm, acos_poly,
                                          hue_histogram_planes,
                                          mip_downsample_planes,
                                          rgb_to_hsi_planes)

#: The JAX harness's pass gates (benchmarks/parity.py:112-117): hues
#: equal, and each max |err| below these.
GATES = {"grads": 5e-3, "spectrum": 1e-3, "pcm": 1e-2}
#: The documented results of that harness (docs/BENCHMARKS.md:413-418),
#: reported beside the measured errors.
BANDS = {"spectrum": 3.4e-5, "pcm": 3e-3}
#: The port's two runners: per frame and chunk-batched.
RUNNERS = {"frame": run_offline, "chunked": run_offline_batched}

# The oracle's AGC and OLA constants (SoundEngine.swift:412-426): attack
# and release 1.0, the hue/spectrum mixing 0.9 and the sigmoid's k = 2.
ATTACK = RELEASE = 1.0
MIXING = 0.9
SIGMOID_K = 2.0


def reference_pipeline(frames, cfg: AuralizerConfig):
    """The complete reference-path oracle in float64 literal math: frames
    (T, H, W, 3) f64 in [0, 1] -> (pcm f64[T*hop], hues i32[T, 16], grads
    f64[T, 16, 4], spectra c128[T, F]), as ``benchmarks/parity.py``'s
    ``reference_pipeline`` computes them.  Mono."""
    live = LiveParams()
    if (live.attack, live.release, live.spectrum_mixing) != (
            ATTACK, RELEASE, MIXING):
        raise RuntimeError(
            f"the oracle's attack/release/mixing ({ATTACK}, {RELEASE}, "
            f"{MIXING}) are no longer LiveParams()'s defaults "
            f"({live.attack}, {live.release}, {live.spectrum_mixing})")
    freqs = cfg.bin_frequencies().astype(np.float64)
    hues = np.zeros(16, np.int32)
    phase_accum = np.zeros(16 * 32)
    prev_spec = np.zeros(cfg.num_bins, np.complex128)
    ola_tail = np.zeros(cfg.nfft)
    running_max = 1.0
    window = hann_window_norm(cfg.nfft).astype(np.float64)
    mixing = MIXING

    pcm_out, hues_hist, grads_hist, spec_hist = [], [], [], []
    for frame in frames:
        mip = oracles.mip_np(frame, cfg.mip_level)
        hist = oracles.hue_histogram_np(mip)
        hues = oracles.update_hues_np(hist, hues, mixing)
        feats = oracles.convolve_features_np(mip)       # rotated (W,H,3,4)
        grads = oracles.cell_grad_stats_np(feats[..., 2, :])

        phase_accum = oracles.phase_accumulate_np(
            phase_accum, hues, freqs, cfg.hop_size, cfg.sample_rate)
        spec = oracles.compute_spectrum_np(
            hues, grads, freqs, prev_spec, phase_accum, mixing,
            cfg.bin_width)
        prev_spec = spec

        # mirror + ifft (HelperFunctions.swift:110-129,155-185)
        full = np.zeros(cfg.nfft, np.complex128)
        full[1:cfg.num_bins + 1] = spec
        full[cfg.nfft - np.arange(1, cfg.num_bins + 1)] = np.conj(spec)
        sig = np.fft.ifft(full).real

        # AGC (SoundEngine.swift:412-426)
        peak = np.abs(sig).max() + 1e-9
        if peak > running_max:
            running_max = peak          # attack = 1.0
        else:
            running_max = peak          # release = 1.0
        scaled = peak / running_max
        k = SIGMOID_K
        g = 1 / (1 + np.exp(-k * (scaled - 0.5)))
        g0 = 1 / (1 + np.exp(k * 0.5))
        g1 = 1 / (1 + np.exp(-k * 0.5))
        nf = np.clip((g - g0) / (g1 - g0), 0, 1)
        sig = sig / (peak / nf)

        # OLA (SoundEngine.swift:231-254)
        gain = 1.0 / (np.abs(sig).max() + 1e-6)
        windowed = sig * gain * window
        pcm = ola_tail[cfg.hop_size:] + windowed[:cfg.hop_size]
        ola_tail = windowed

        pcm_out.append(pcm)
        hues_hist.append(hues.copy())
        grads_hist.append(grads.copy())
        spec_hist.append(spec.copy())
    return (np.concatenate(pcm_out), np.stack(hues_hist),
            np.stack(grads_hist), np.stack(spec_hist))


def oracle_input(frames) -> np.ndarray:
    """The oracle's view of the port's frames: u8 as ``frames / 255`` in
    float64, f32 in [0, 1] as float64."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return frames.astype(np.float64) / 255.0
    return frames.astype(np.float64)


def run_parity(frames, cfg: AuralizerConfig, device=None,
               runner: str = "frame", reference=None) -> dict:
    """The port against :func:`reference_pipeline` on the same frames.

    ``frames`` (T, H, W, 3), u8 (the port takes them as u8, so K1 runs) or
    f32 in [0, 1]; ``cfg`` mono.  ``runner`` "frame" runs
    :func:`runtime.step.run_offline`, "chunked"
    :func:`runtime.chunked.run_offline_batched`, with ``debug=True`` and
    ``LiveParams()`` on ``device`` (:func:`vaudio_torch.device`: the card
    unless given).  ``reference`` is the result of
    :func:`reference_pipeline` on :func:`oracle_input` of the frames,
    computed here when not given (one oracle run can serve both runners).

    Returns a JSON-able report: ``hues_identical``, ``max_abs_err`` of
    grads, spectrum and PCM, ``gates`` and ``ok`` (hues equal and every
    error below its gate), and ``bands``, the documented spectrum and PCM
    results, with ``within_bands``.
    """
    if cfg.channels != 1:
        raise ValueError("run_parity: the literal oracle is mono; got "
                         f"channels={cfg.channels}")
    frames = np.asarray(frames)
    if reference is None:
        reference = reference_pipeline(oracle_input(frames), cfg)
    ref_pcm, ref_hues, ref_grads, ref_spec = reference
    dev = pick_device(device)
    audio, _, dbg = RUNNERS[runner](frames, cfg,
                                    params=LiveParams().as_arrays(),
                                    debug=True, device=dev)
    spec = dbg["spectrum"].cpu().numpy()
    spec_c = spec[..., 0] + 1j * spec[..., 1]
    hues_identical = bool(np.array_equal(dbg["hues"].cpu().numpy(),
                                         ref_hues))
    err = {"grads": float(np.abs(dbg["grads"].cpu().numpy()
                                 - ref_grads).max()),
           "spectrum": float(np.abs(spec_c - ref_spec).max()),
           "pcm": float(np.abs(audio.cpu().numpy() - ref_pcm).max())}
    return {"runner": runner, "device": str(dev),
            "frames": list(frames.shape), "dtype": str(frames.dtype),
            "hues_identical": hues_identical, "max_abs_err": err,
            "gates": dict(GATES), "bands": dict(BANDS),
            "within_bands": {k: err[k] <= BANDS[k] for k in BANDS},
            "ok": hues_identical and all(err[k] < GATES[k] for k in GATES)}


# ---------------------------------------------------------------------------
# The device audit
# ---------------------------------------------------------------------------

def mip_oracle(planes_u8: np.ndarray, level: int, scale: float):
    """The f64 box mean of u8 planes (C, H, W), ragged rows and columns
    dropped (``benchmarks/tpu_parity.py:42-48``)."""
    c, h, w = planes_u8.shape
    k = 1 << level
    ho, wo = h >> level, w >> level
    x = planes_u8[:, :ho * k, :wo * k].astype(np.float64)
    return x.reshape(c, ho, k, wo, k).sum(axis=(2, 4)) * (scale / (k * k))


def histogram_oracle(hp, sp, ip, cfg: AuralizerConfig) -> np.ndarray:
    """Straight integer binning of HSI planes (hm, wm) into the per-cell
    hue histogram (``benchmarks/tpu_parity.py:92-104``)."""
    hm, wm = hp.shape
    gate = (sp > cfg.saturation_gate) & (ip > cfg.intensity_gate)
    bins_i = np.clip((hp * np.float32(cfg.num_hue_bins - 1)
                      ).astype(np.int32), 0, cfg.num_hue_bins - 1)
    y, x = np.mgrid[0:hm, 0:wm]
    cell = (x * cfg.grid_size) // wm * cfg.grid_size \
        + ((hm - 1 - y) * cfg.grid_size) // hm
    out = np.zeros((cfg.num_cells, cfg.num_hue_bins))
    np.add.at(out, (cell[gate], bins_i[gate]), 1.0)
    return out


def agc_ola_oracle(signals, ola_tail, window, running_max, attack,
                   release, k: float = SIGMOID_K):
    """The audio tail in float64 (SoundEngine.swift:231-254,412-426): per
    frame the attack/release peak EMA, the sigmoid normalisation, the
    peak renormalisation, the window and the overlap-add.  signals
    (T, nfft) -> (pcm (T, nfft/2), the last tail, the running max)."""
    hop = signals.shape[-1] // 2
    g0 = 1 / (1 + np.exp(k * 0.5))
    g1 = 1 / (1 + np.exp(-k * 0.5))
    rm = float(running_max)
    tail = np.asarray(ola_tail, np.float64)
    pcm = []
    for sig in np.asarray(signals, np.float64):
        peak = np.abs(sig).max() + 1e-9
        if peak > rm:
            rm = attack * peak + (1 - attack) * rm
        else:
            rm = release * peak + (1 - release) * rm
        g = 1 / (1 + np.exp(-k * (peak / rm - 0.5)))
        nf = np.clip((g - g0) / (g1 - g0), 0, 1)
        sig = sig / (peak / nf)
        windowed = sig * (1.0 / (np.abs(sig).max() + 1e-6)) * window
        pcm.append(tail[hop:] + windowed[:hop])
        tail = windowed
    return np.stack(pcm), tail, rm


def _circ(a, b) -> float:
    """Largest circular distance of two phase arrays (mod 2 pi)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.minimum(d, 2 * np.pi - d).max())


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def audit_stages(device=None, res: str = "1080x1920",
                 seed: int = 20260816) -> dict:
    """Each parity-critical stage on ``device`` against a float64 oracle
    on the host, at frames of ``res`` ("HxW"; mips at level 3).

    The stages and tolerances of the TPU audit
    (``benchmarks/tpu_parity.py:51-220``): ``mip_k1`` (K1 on interleaved
    u8 frames), ``mip_f32_path``, ``mip_planes_k1`` (K1's planar entry),
    ``histogram_k3`` (``hue_histogram_planes`` and K3's histogram, exact),
    ``acos_poly_dense_grid``, ``hsi_hue_poly_vs_exact``,
    ``contraction_k2`` (K2 against the f64 product of the same f32 peak
    matrix), the serial and prefix-sum phase paths at T = 128 and their
    ratio; then the GPU's own: ``agc_ola_k4`` (K4 in the chunk order at T
    = 8 with ``LiveParams()``'s attack and release, band 1e-5),
    ``irfft_dense_matmul`` and ``spectrum_ema_matmul`` (bands 1e-5 of
    the oracle's peak).

    Returns a JSON-able report: per stage ``max_abs_err``, ``tol`` and
    ``ok`` (or ``error`` where the stage raised; it then fails), and
    ``ok`` over all.  On a CUDA device a kernel stage whose kernel did
    not launch fails.
    """
    dev = pick_device(device)
    h, w = (int(x) for x in res.split("x"))
    rng = np.random.default_rng(seed)
    report = {"device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else str(dev)),
              "res": res, "seed": seed, "stages": {}, "ok": True}

    def check(names, tols, fn, counter=None):
        """Run ``fn`` (-> one error per name) and record each stage; with
        ``counter`` (module, attribute), the kernel's launch count must
        move on a CUDA device."""
        before = getattr(*counter) if counter else 0
        try:
            errs = fn()
            if (counter and dev.type == "cuda"
                    and getattr(*counter) == before):
                raise RuntimeError(f"{counter[0].__name__}.{counter[1]}: "
                                   "the CUDA kernel did not launch")
            entries = [{"max_abs_err": float(e), "tol": float(t),
                        "ok": bool(float(e) <= t)}
                       for e, t in zip(errs, tols)]
        except Exception as e:                  # the stage fails, recorded
            entries = [{"error": repr(e), "tol": float(t), "ok": False}
                       for t in tols]
        for name, entry in zip(names, entries):
            report["stages"][name] = entry
            report["ok"] &= entry["ok"]

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    # -- K1 and the f32 mip path against the f64 box mean
    planes = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    mip_ref = mip_oracle(planes, 3, 1 / 255.0)
    check(["mip_k1"], [1e-6], lambda: [np.abs(_np(pool_kernel.mip_pool(
        on(planes.transpose(1, 2, 0)[None]), 3, 1 / 255.0))[0]
        - mip_ref).max()], (pool_kernel, "launches"))
    check(["mip_f32_path"], [2e-6], lambda: [np.abs(_np(
        mip_downsample_planes(on(planes.astype(np.float32) / 255.0), 3))
        - mip_ref).max()])
    check(["mip_planes_k1"], [1e-6], lambda: [np.abs(_np(
        pool_kernel.mip_pool_planes(on(planes), 3, 1 / 255.0))
        - mip_ref).max()], (pool_kernel, "planar_launches"))

    # -- the hue histogram and K3's, exact
    cfg = AuralizerConfig()
    hm, wm = h >> 3, w >> 3
    hp, sp, ip = (rng.random((hm, wm), dtype=np.float64).astype(np.float32)
                  for _ in range(3))
    mips = rng.random((3, hm, wm), dtype=np.float64).astype(np.float32)

    def histograms():
        got = _np(hue_histogram_planes(on(hp), on(sp), on(ip), cfg))
        # K3 computes its HSI from RGB mips: bin the planes of the port's
        # plain HSI with K3's acos (on the host) as its oracle.
        kh, ks, ki = (_np(x) for x in rgb_to_hsi_planes(
            *torch.as_tensor(mips), acos=acos_fdlibm))
        k3 = _np(vision_kernel.vision_stats(on(mips[None]), cfg)[0][0])
        return [max(np.abs(got - histogram_oracle(hp, sp, ip, cfg)).max(),
                    np.abs(k3 - histogram_oracle(kh, ks, ki, cfg)).max())]

    check(["histogram_k3"], [0.0], histograms, (vision_kernel, "launches"))

    # -- the polynomial acos on a dense grid, and its hue against acos's
    xg = np.linspace(-1.0, 1.0, 200_001).astype(np.float32)
    check(["acos_poly_dense_grid"], [8e-7], lambda: [np.abs(
        _np(acos_poly(on(xg))) - np.arccos(xg.astype(np.float64))).max()])
    rgb = [on(rng.random((hm, wm), dtype=np.float64).astype(np.float32))
           for _ in range(3)]
    check(["hsi_hue_poly_vs_exact"], [1e-6], lambda: [np.abs(
        _np(rgb_to_hsi_planes(*rgb, fast_acos=True)[0])
        - _np(rgb_to_hsi_planes(*rgb, fast_acos=False)[0])).max()])

    # -- K2 against the f64 product of the same f32 peak matrix
    consts = SynthConstants.create(cfg, dev)
    npartials = int(consts.seed_phase.numel())
    pf = rng.uniform(30.0, 8000.0, npartials).astype(np.float32)
    wgt = rng.normal(0, 1e-3, (npartials, 2)).astype(np.float32)
    ibw = np.full(npartials, 1.0 / cfg.narrow_bandwidth, np.float32)
    d32 = (_np(consts.freqs)[:, None] - pf[None, :]) \
        * (np.float32(1.0 / cfg.bin_width) * ibw)[None, :]
    k2_ref = _np(hann_sinc_peak_fast(on(d32))).astype(np.float64) \
        @ wgt.astype(np.float64)
    check(["contraction_k2"], [np.abs(k2_ref).max() * 2e-6 + 1e-9],
          lambda: [np.abs(_np(contract_spectrum(on(pf), on(wgt), on(ibw),
                                                cfg, consts))
                          - k2_ref).max()],
          (spectrum_kernel, "launches"))

    # -- the phases, serial and prefix-sum, at T = 128 against f64
    T = 128
    hues_seq = on(rng.integers(0, 360, (T, cfg.num_cells)).astype(np.int32))
    p0 = on(rng.uniform(0, 2 * np.pi, tuple(init_carry(cfg, "cpu").phases
                                            .shape)).astype(np.float32))

    def phase_paths():
        two_pi = float(np.float32(2.0 * np.pi))
        serial = p0
        for t in range(T):
            serial = phase_accumulate(serial, hues_seq[t], cfg, consts)
        adv = phase_advance(hues_seq, cfg, consts)
        pre = associative_scan(lambda a, b: torch.remainder(a + b, two_pi),
                               torch.remainder(adv, two_pi))
        cum = torch.remainder(p0 + pre[-1], two_pi)
        ref = np.mod(_np(p0).astype(np.float64)
                     + _np(adv).astype(np.float64).sum(axis=0), 2 * np.pi)
        e_serial, e_cum = _circ(_np(serial), ref), _circ(_np(cum), ref)
        return [e_serial, e_cum, _circ(_np(cum), _np(serial)),
                e_cum / max(e_serial, 1e-9)]

    check(["phase_serial_vs_f64", "phase_cumsum_vs_f64",
           "phase_cumsum_vs_serial", "phase_cumsum_over_serial_ratio"],
          [3.2e-2, 3.2e-2, 2e-2, 2.0], phase_paths)

    # -- the GPU's own traps: K4, the dense irfft, the matrix EMA
    live = LiveParams()
    window = hann_window_norm(cfg.nfft)
    signals = (rng.normal(size=(8, cfg.nfft))
               * rng.uniform(0.01, 10.0, (8, 1))).astype(np.float32)
    tail = (rng.uniform(-1, 1, cfg.nfft) * window).astype(np.float32)

    def k4():
        f32 = torch.float32
        pcm, new_tail, rm = audio_kernel.agc_overlap_add_chunk(
            on(signals), on(tail), on(window), torch.ones((), dtype=f32,
                                                          device=dev),
            torch.full((), live.attack, dtype=f32, device=dev),
            torch.full((), live.release, dtype=f32, device=dev))
        ref = agc_ola_oracle(signals, tail, window, 1.0, live.attack,
                             live.release)
        return [max(np.abs(_np(pcm) - ref[0]).max(),
                    np.abs(_np(new_tail) - ref[1]).max(),
                    abs(float(rm) - ref[2]))]

    check(["agc_ola_k4"], [1e-5], k4, (audio_kernel, "launches"))

    spec = rng.normal(size=(4, cfg.num_bins, 2)).astype(np.float32)
    s64 = spec.astype(np.float64)
    half = np.pad(s64[..., 0] + 1j * s64[..., 1], ((0, 0), (1, 1)))
    irfft_ref = np.fft.irfft(half, n=cfg.nfft)
    check(["irfft_dense_matmul"], [1e-5 * np.abs(irfft_ref).max()],
          lambda: [np.abs(_np(irfft_from_half_dense(on(spec)))
                          - irfft_ref).max()])

    rot = rng.normal(size=(64, cfg.num_bins, 2)).astype(np.float32)
    prev = rng.normal(size=(cfg.num_bins, 2)).astype(np.float32)
    m32 = np.float32(live.spectrum_mixing)
    ema_ref, s = [], prev.astype(np.float64)
    for r in rot.astype(np.float64):
        s = s * float(m32) + r * (1.0 - float(m32))
        ema_ref.append(s)
    ema_ref = np.stack(ema_ref)
    check(["spectrum_ema_matmul"], [1e-5 * np.abs(ema_ref).max()],
          lambda: [np.abs(_np(_matmul_ema(on(rot), on(prev), on(m32)))
                          - ema_ref).max()])
    return report
