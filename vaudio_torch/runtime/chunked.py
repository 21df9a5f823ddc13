"""Chunk-batched execution — the PyTorch port of
:mod:`vaudio.runtime.chunked`, the main path from frames to audio.

The same math as T :func:`vaudio_torch.runtime.step.frame_step` calls,
with every per-frame stage batched over the chunk and only the serial
recurrences left as Python loops of small launches: the hue EMA, the
spectrum EMA and the AGC running max (``lax.scan`` in the JAX package).
On CUDA tensors the mip pool and the spectrum contraction run as the CUDA
kernels K1 and K2 (``vaudio_torch.ops``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from vaudio_torch import check_config
from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import (hann_window_norm, irfft_from_half,
                                   sigmoid_normalize)
from vaudio_torch.runtime.step import (StepCarry, carry_from_numpy,
                                       check_frames, frames_to_device,
                                       init_carry, params_to_device)
from vaudio_torch.synth.spectrum import (SynthConstants, contract_spectrum,
                                         filter_gain_from_params,
                                         flatten_partials,
                                         live_pan_from_params,
                                         partial_weights, phase_accumulate,
                                         phase_advance, rotate_spectrum)
from vaudio_torch.vision.features import (frame_stats, hist_max_and_arg,
                                          update_hues_from_stats)


def associative_scan(fn: Callable, x):
    """Inclusive scan of ``x`` along dim 0 with the associative ``fn``, in
    exactly the combine order of ``jax.lax.associative_scan``: pairs are
    reduced, the half-size scan recurses, and the even outputs combine the
    odd ones with the next element.  With a combine that rounds (the mod-2pi
    add of the phase prefix sum) the order decides the bits."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = associative_scan(fn, fn(x[0:-1:2], x[1::2]))
    even = fn(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    out = torch.empty_like(x)
    out[0::2] = torch.cat([x[:1], even])
    out[1::2] = odd
    return out


def chunk_pipeline(carry: StepCarry, frames, params: Dict[str, Any],
                   cfg: AuralizerConfig, consts: SynthConstants, window,
                   debug: bool = False):
    """Process a chunk of T frames (T, H, W, 3) on their device; returns
    (new_carry, out) with out["pcm"] f32[T, hop] mono or f32[T, hop,
    channels] stereo, and with ``debug`` also hues, grads and spectrum
    per frame.  ``params`` as from :func:`runtime.step.params_to_device`."""
    check_config(cfg)
    ch = cfg.channels
    mixing = params["spectrum_mixing"]
    T = frames.shape[0]

    # ---- pass A: vision stats batched; hue EMA (and phases) serial ----
    hists, grads_seq = frame_stats(frames, cfg)         # (T,16,360), (T,16,4)
    max_vals, args = hist_max_and_arg(hists)

    hues = carry.hues
    hue_list = []
    for t in range(T):
        hues = update_hues_from_stats(max_vals[t], args[t], hues, mixing,
                                      cfg)
        hue_list.append(hues)
    hues_seq = torch.stack(hue_list)
    if cfg.use_cumsum_phases:
        # phases_t = (phases_0 + sum_{k<=t} adv_k) mod 2pi as the JAX
        # package's mod-2pi associative scan, in its combine order.
        two_pi = float(np.float32(2.0 * np.pi))
        adv = phase_advance(hues_seq, cfg, consts)      # (T, 16, 32)
        prefix = associative_scan(
            lambda a, b: torch.remainder(a + b, two_pi),
            torch.remainder(adv, two_pi))
        phases_seq = torch.remainder(carry.phases[None] + prefix, two_pi)
    else:
        phases = carry.phases
        phase_list = []
        for t in range(T):
            phases = phase_accumulate(phases, hues_seq[t], cfg, consts)
            phase_list.append(phases)
        phases_seq = torch.stack(phase_list)

    # ---- pass B: weights + ONE batched contraction (K2) + rotation ----
    pan = live_pan_from_params(cfg, params, frames.device)
    pf, w_re, w_im, inv_bw = partial_weights(hues_seq, grads_seq, phases_seq,
                                             cfg, consts)
    flat_pf, flat_w, flat_ibw = flatten_partials(pf, w_re, w_im, inv_bw, cfg,
                                                 pan=pan)
    cur = contract_spectrum(flat_pf, flat_w, flat_ibw, cfg, consts)
    rot = rotate_spectrum(cur, cfg, consts)             # (T, [ch,] F, 2)
    if cfg.enable_filters:
        rot = rot * filter_gain_from_params(params, consts)

    # ---- pass C1: spectrum EMA, serial ----
    prev = carry.prev_spectrum
    spec_list = []
    for t in range(T):
        prev = prev * mixing + rot[t] * (1.0 - mixing)
        spec_list.append(prev)
    spectra = torch.stack(spec_list)

    # ---- pass C2: audio tail, scalars serial / samples batched ----
    signals = irfft_from_half(spectra)                  # (T, [ch,] nfft)
    axes = tuple(range(1, signals.ndim))
    peaks = torch.amax(torch.abs(signals), dim=axes) + 1e-9
    attack, release = params["attack"], params["release"]
    rm = carry.running_max
    max_list = []
    for t in range(T):
        p = peaks[t]
        attacked = attack * p + (1.0 - attack) * rm
        released = release * p + (1.0 - release) * rm
        rm = torch.where(p > rm, attacked, released)
        max_list.append(rm)
    new_maxes = torch.stack(max_list)
    norm_factor = torch.clamp(sigmoid_normalize(peaks, new_maxes), 0.0, 1.0)
    inv = 1.0 / (peaks / norm_factor)
    scale = torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))
    bshape = (T,) + (1,) * (signals.ndim - 1)
    normalized = signals * scale.reshape(bshape)
    normalized = torch.where(torch.isfinite(normalized), normalized,
                             torch.zeros_like(normalized))

    hop = cfg.hop_size
    fpeaks = torch.amax(torch.abs(normalized), dim=axes)
    gains = 1.0 / (fpeaks + 1e-6)
    windowed = normalized * gains.reshape(bshape) * window
    prev_tails = torch.cat([carry.ola_tail[None], windowed[:-1]])
    pcm = prev_tails[..., hop:] + windowed[..., :hop]
    if ch != 1:
        pcm = pcm.transpose(1, 2)                       # (T, hop, channels)

    new_carry = StepCarry(hues=hues_seq[-1], phases=phases_seq[-1],
                          prev_spectrum=prev, ola_tail=windowed[-1],
                          running_max=rm)
    out: Dict[str, Any] = {"pcm": pcm}
    if debug:
        out.update(hues=hues_seq, grads=grads_seq, spectrum=spectra)
    return new_carry, out


def blocked_pipeline(carry: StepCarry, frames, params: Dict[str, Any],
                     cfg: AuralizerConfig, consts: SynthConstants, window,
                     block: int = 8, debug: bool = False):
    """:func:`chunk_pipeline` over consecutive ``block``-frame pieces of a
    clip whose length is a multiple of ``block``."""
    T = frames.shape[0]
    if T % block:
        raise ValueError(f"blocked_pipeline: T={T} not a multiple of "
                         f"block={block}")
    outs = []
    for start in range(0, T, block):
        carry, out = chunk_pipeline(carry, frames[start:start + block],
                                    params, cfg, consts, window, debug=debug)
        outs.append(out)
    return carry, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def make_chunk_pipeline(cfg: AuralizerConfig, debug: bool = False,
                        device=None):
    """``chunk_step(carry, frames[T, ...], params)`` with the constants
    built once on ``device``; ``frames`` on the host or the device,
    ``params`` as host values or as from
    :func:`runtime.step.params_to_device`."""
    dev = pick_device(device)
    consts = SynthConstants.create(cfg, dev)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=dev)

    def step(carry, frames, params):
        return chunk_pipeline(carry, frames_to_device(frames, dev),
                              params_to_device(params, cfg, dev), cfg,
                              consts, window, debug=debug)

    return step


def run_offline_batched(frames, cfg: AuralizerConfig,
                        params: Dict[str, Any] | None = None,
                        carry: StepCarry | None = None,
                        chunk: int = 64, debug: bool = False, device=None):
    """Offline sonification through the chunk-batched pipeline, ``chunk``
    frames at a time (the last piece may be shorter), carrying the DSP
    state across pieces.  ``frames`` (T, H, W, 3) u8 or f32, numpy or a
    tensor; each piece is moved to ``device`` as it is processed.

    Returns (audio f32[T*hop] or f32[T*hop, channels], final_carry,
    debug_dict of per-frame hues/grads/spectra when ``debug``), tensors on
    ``device``.
    """
    dev = pick_device(device)
    frames = check_frames(frames)
    step = make_chunk_pipeline(cfg, debug=debug, device=dev)
    params = params_to_device(params, cfg, dev)
    carry = init_carry(cfg, dev) if carry is None \
        else carry_from_numpy(carry, dev)
    T = frames.shape[0]
    outs = []
    for start in range(0, T, chunk):
        carry, out = step(carry, frames[start:start + chunk], params)
        outs.append(out)
    outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    audio = outs.pop("pcm")
    audio = audio.reshape(-1) if cfg.channels == 1 \
        else audio.reshape(-1, cfg.channels)
    return audio, carry, outs
