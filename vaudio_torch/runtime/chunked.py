"""Chunk-batched execution — the PyTorch port of
:mod:`vaudio.runtime.chunked`, the main path from frames to audio.

The same math as T :func:`vaudio_torch.runtime.step.frame_step` calls,
with every per-frame stage batched over the chunk and only the serial
recurrences left as Python loops of small launches: the hue EMA and the
spectrum EMA (``lax.scan`` in the JAX package).  On CUDA tensors the mip
pool, the spectrum contraction and the audio tail with its running-max
recurrence run as the CUDA kernels K1, K2 and K4 (``vaudio_torch.ops``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import (hann_window_norm, irfft_from_half,
                                   irfft_from_half_dense)
from vaudio_torch.ops.audio_kernel import agc_overlap_add_chunk
from vaudio_torch.runtime.step import (StepCarry, carry_from_numpy,
                                       check_frames, frames_slice,
                                       frames_to_device, init_carry,
                                       num_frames, params_to_device)
from vaudio_torch.synth.spectrum import (SynthConstants, _stream_rows,
                                         contract_spectrum,
                                         filter_gain_from_params,
                                         flatten_partials,
                                         live_pan_from_params,
                                         partial_weights, phase_accumulate,
                                         phase_advance, rotate_spectrum)
from vaudio_torch.utils.profiling import span
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
    """Process a chunk of T frames (T, H, W, 3), or a dict of YUV planes
    (T, ...), on their device; returns (new_carry, out) with out["pcm"]
    f32[T, hop] mono or f32[T, hop, channels] stereo, and with ``debug``
    also hues, grads and spectrum per frame.  ``params`` as from
    :func:`runtime.step.params_to_device`.

    With a leading stream axis — a carry whose fields lead with S, frames
    (S, T, H, W, 3) or planes (S, T, ...), and params whose values lead
    with S (``runtime.multistream``) — the S streams run as one batch: the
    stateless per-frame stages fold the S·T frames into one frame axis
    (one K1, K3 and K2 launch), the serial recurrences step [S, ...] frame
    by frame (time leads inside) with each stream's own params, and K4
    runs with its stream axis; every result leads with S."""
    mixing = params["spectrum_mixing"]
    pod = carry.hues.dim() == 2
    if pod:
        S, T = (frames["y"] if isinstance(frames, dict) else frames).shape[:2]
        frames = ({k: v.flatten(0, 1) for k, v in frames.items()}
                  if isinstance(frames, dict) else frames.flatten(0, 1))
    else:
        T = num_frames(frames)

    # ---- pass A: vision stats batched; hue EMA (and phases) serial ----
    with span("vaudio.step.vision"):
        hists, grads_seq = frame_stats(frames, cfg)     # (T,16,360), (T,16,4)
        if pod:                                 # time-major: (T, S, 16, .)
            hists, grads_seq = (
                x.reshape((S, T) + x.shape[1:]).transpose(0, 1)
                for x in (hists, grads_seq))
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
            adv = phase_advance(hues_seq, cfg, consts)  # (T, 16, 32)
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
    with span("vaudio.step.synth"):
        pan = live_pan_from_params(cfg, params, mixing.device)
        pf, w_re, w_im, inv_bw = partial_weights(hues_seq, grads_seq,
                                                 phases_seq, cfg, consts)
        flat_pf, flat_w, flat_ibw = flatten_partials(pf, w_re, w_im, inv_bw,
                                                     cfg, pan=pan)
        cur = contract_spectrum(flat_pf, flat_w, flat_ibw, cfg, consts)
        rot = rotate_spectrum(cur, cfg, consts)         # (T, [ch,] F, 2)
        if cfg.enable_filters:
            rot = rot * filter_gain_from_params(params, consts, cfg.channels)

        # ---- pass C1: spectrum EMA, serial, or one matrix product ----
        if cfg.use_matmul_ema:
            spectra = _matmul_ema(rot, carry.prev_spectrum, mixing)
            prev = spectra[-1]
        else:
            prev = carry.prev_spectrum
            m = _stream_rows(mixing, prev.dim())
            spec_list = []
            for t in range(T):
                prev = prev * m + rot[t] * (1.0 - m)
                spec_list.append(prev)
            spectra = torch.stack(spec_list)

    # ---- pass C2: audio tail, one call of K4 over the chunk ----
    with span("vaudio.step.dsp"):
        signals = (irfft_from_half_dense(spectra) if cfg.use_matmul_irfft
                   else irfft_from_half(spectra))       # (T, [ch,] nfft)
        if pod:                                         # (S, T, [ch,] nfft)
            signals = signals.transpose(0, 1).contiguous()
        pcm, ola_tail, rm = agc_overlap_add_chunk(
            signals, carry.ola_tail, window, carry.running_max,
            params["attack"], params["release"])        # (T, hop[, ch])

    new_carry = StepCarry(hues=hues_seq[-1], phases=phases_seq[-1],
                          prev_spectrum=prev, ola_tail=ola_tail,
                          running_max=rm)
    out: Dict[str, Any] = {"pcm": pcm}
    if debug:
        out.update(hues=hues_seq, grads=grads_seq, spectrum=spectra)
        if pod:
            out.update({k: v.transpose(0, 1) for k, v in out.items()
                        if k != "pcm"})
    return new_carry, out


def _matmul_ema(rot, prev, mixing):
    """The spectrum EMA of a chunk in closed form (cfg.use_matmul_ema,
    vaudio/runtime/chunked.py:201-224): spec_t = m^(t+1) prev + (1 - m)
    sum_{k<=t} m^(t-k) rot_k as one lower-triangular (T, T) f32 product
    (TF32 is off).  Reassociated against the serial EMA (~1e-6 abs at
    T=64), and torch.pow may differ from XLA's by an ulp.  With a stream
    axis (rot (T, S, ...), mixing f32[S]) one (T, T) matrix a stream, in
    one batched product."""
    T = rot.shape[0]
    t_idx = torch.arange(T, device=rot.device)
    lower = t_idx[:, None] >= t_idx[None, :]
    tk = (t_idx[:, None] - t_idx[None, :]).to(torch.float32)
    steps = torch.arange(1, T + 1, dtype=torch.float32, device=rot.device)
    if mixing.dim() == 1:
        S = mixing.shape[0]
        m = mixing[:, None, None]
        L = torch.where(lower, (1.0 - m) * torch.pow(
            m, torch.where(lower, tk, torch.zeros_like(tk))),
            torch.zeros_like(tk))                        # (S, T, T)
        pows = torch.pow(mixing[:, None], steps)         # (S, T)
        spectra = torch.matmul(L, rot.reshape(T, S, -1).transpose(0, 1)) \
            + pows[..., None] * prev.reshape(S, 1, -1)
        return spectra.transpose(0, 1).reshape(rot.shape)
    L = torch.where(lower, (1.0 - mixing) * torch.pow(
        mixing, torch.where(lower, tk, torch.zeros_like(tk))),
        torch.zeros_like(tk))
    pows = torch.pow(mixing, steps)
    spectra = torch.matmul(L, rot.reshape(T, -1)) \
        + pows[:, None] * prev.reshape(1, -1)
    return spectra.reshape(rot.shape)


def blocked_pipeline(carry: StepCarry, frames, params: Dict[str, Any],
                     cfg: AuralizerConfig, consts: SynthConstants, window,
                     block: int = 8, debug: bool = False):
    """:func:`chunk_pipeline` over consecutive ``block``-frame pieces of a
    clip whose length is a multiple of ``block``."""
    T = num_frames(frames)
    if T % block:
        raise ValueError(f"blocked_pipeline: T={T} not a multiple of "
                         f"block={block}")
    outs = []
    for start in range(0, T, block):
        carry, out = chunk_pipeline(carry,
                                    frames_slice(frames, start, start + block),
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
    state across pieces.  ``frames`` (T, H, W, 3) u8 or f32, or a dict
    ``{"y", "u", "v"}`` of planar u8 YUV 4:2:0, numpy or tensors; each
    piece is moved to ``device`` as it is processed.

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
    T = num_frames(frames)
    outs = []
    for start in range(0, T, chunk):
        with span("vaudio.step"):
            carry, out = step(carry,
                              frames_slice(frames, start, start + chunk),
                              params)
        outs.append(out)
    outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    audio = outs.pop("pcm")
    audio = audio.reshape(-1) if cfg.channels == 1 \
        else audio.reshape(-1, cfg.channels)
    return audio, carry, outs
