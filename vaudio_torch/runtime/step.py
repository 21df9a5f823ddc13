"""The per-frame frame->audio step and its offline loop — the PyTorch port
of :mod:`vaudio.runtime.step`.

The recurrent DSP state is an explicit :class:`StepCarry` of tensors with
the JAX package's fields and shapes; ``lax.scan`` becomes a Python loop.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp.core import (agc_normalize, hann_window_norm,
                                   irfft_from_half, irfft_from_half_dense,
                                   overlap_add)
from vaudio_torch.ops.audio_kernel import agc_overlap_add
from vaudio_torch.synth.spectrum import (SynthConstants, build_spectrum,
                                         phase_accumulate)
from vaudio_torch.utils.profiling import span
from vaudio_torch.vision.features import extract_features


class StepCarry(NamedTuple):
    """The recurrent DSP state of one audio stream."""

    hues: torch.Tensor           # i32[16]       — EMA-smoothed hues
    phases: torch.Tensor         # f32[16, 32]   — partial phase accumulators
    prev_spectrum: torch.Tensor  # f32[F, 2] mono, f32[2, F, 2] stereo
    ola_tail: torch.Tensor       # f32[nfft] mono, f32[2, nfft] stereo
    running_max: torch.Tensor    # f32[]         — AGC envelope


def init_carry(cfg: AuralizerConfig, device=None) -> StepCarry:
    """The reference's cold start: hues 0, phases/spectrum/tail 0, running
    max 1.0 (VisionEngine.swift:33, SoundEngine.swift:73), on ``device``
    (:func:`vaudio_torch.device`: the card unless given)."""
    device = pick_device(device)
    spec_shape = (cfg.num_bins, 2) if cfg.channels == 1 \
        else (cfg.channels, cfg.num_bins, 2)
    tail_shape = (cfg.nfft,) if cfg.channels == 1 \
        else (cfg.channels, cfg.nfft)
    f32 = dict(dtype=torch.float32, device=device)
    return StepCarry(
        hues=torch.zeros((cfg.num_cells,), dtype=torch.int32, device=device),
        phases=torch.zeros((cfg.num_cells, cfg.phase_stride), **f32),
        prev_spectrum=torch.zeros(spec_shape, **f32),
        ola_tail=torch.zeros(tail_shape, **f32),
        running_max=torch.tensor(1.0, **f32),
    )


def carry_from_numpy(carry, device=None) -> StepCarry:
    """A :class:`StepCarry` on ``device`` (:func:`vaudio_torch.device`: the
    card unless given) from tensors or numpy-convertible fields: a dict,
    or a NamedTuple such as the JAX package's ``StepCarry``.  Host arrays
    are copied, never shared."""
    device = pick_device(device)
    fields = carry._asdict() if hasattr(carry, "_asdict") else dict(carry)
    return StepCarry(**{
        name: (fields[name].to(device) if isinstance(fields[name],
                                                     torch.Tensor)
               else torch.as_tensor(np.array(fields[name]), device=device))
        for name in StepCarry._fields})


def carry_to_numpy(carry: StepCarry) -> Dict[str, np.ndarray]:
    """The carry as a dict of numpy arrays (the JAX package's dtypes)."""
    return {name: getattr(carry, name).cpu().numpy()
            for name in StepCarry._fields}


def default_params(cfg: AuralizerConfig) -> Dict[str, np.float32]:
    return LiveParams().as_arrays()


def params_to_device(params: Optional[Dict[str, Any]], cfg: AuralizerConfig,
                     device) -> Dict[str, torch.Tensor]:
    """Live params as f32 tensors on ``device``, so that every op on them
    runs in f32 as in the JAX package.  Host values (numpy, numbers) are
    copied; f32 tensors already on ``device`` pass through."""
    if params is None:
        params = default_params(cfg)
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return _params_as_f32(params, device)
    with span("vaudio.ingest.params"):
        return _params_as_f32(params, device)


def _params_as_f32(params: Dict[str, Any], device):
    return {k: torch.as_tensor(
                v if isinstance(v, torch.Tensor) else np.asarray(v, np.float32),
                dtype=torch.float32, device=device)
            for k, v in params.items()}


def synth_audio(spectrum, ola_tail, running_max, params: Dict[str, Any],
                cfg: AuralizerConfig, window):
    """irfft -> AGC -> overlap-add (SoundEngine.swift:403-428); stereo
    shares one AGC/OLA gain and returns pcm as (hop, channels).  With
    ``cfg.use_pallas`` or ``cfg.use_pallas_audio`` the AGC and overlap-add
    are kernel K4 at T=1 in the frame order
    (:func:`ops.audio_kernel.agc_overlap_add`), as the JAX package runs its
    fused kernel there.
    ``cfg.use_matmul_irfft`` takes the dense inverse DFT
    (:func:`dsp.core.irfft_from_half_dense`) for the FFT.  With a stream
    axis (running_max f32[S]) every peak and gain is per stream and every
    result leads with S.
    Returns (pcm, new_ola_tail, new_running_max)."""
    signal = (irfft_from_half_dense(spectrum) if cfg.use_matmul_irfft
              else irfft_from_half(spectrum))
    if cfg.use_pallas or cfg.use_pallas_audio:
        pcm, new_tail, new_max = agc_overlap_add(
            signal, ola_tail, window, running_max, params["attack"],
            params["release"])
    else:
        normalized, new_max = agc_normalize(
            signal, running_max, params["attack"], params["release"])
        pcm, new_tail = overlap_add(normalized, ola_tail, window,
                                    stream_axis=running_max.dim() == 1)
    if cfg.channels != 1:
        pcm = pcm.transpose(-1, -2)
    return pcm, new_tail, new_max


def frame_step(carry: StepCarry, frame, params: Dict[str, Any],
               cfg: AuralizerConfig, consts: SynthConstants, window,
               debug: bool = False):
    """One video frame (H, W, 3), or a dict of its YUV planes, in, one
    audio hop out: vision -> phase
    accumulation -> spectrum -> irfft/AGC/OLA.  ``params`` as from
    :func:`params_to_device`.  Returns (new_carry, out) with out["pcm"]
    f32[hop] (mono) or f32[hop, channels]; with ``debug`` also hues, grads
    and spectrum.

    With a leading stream axis — a carry whose fields lead with S, one
    frame of each stream (S, H, W, 3) or planes (S, ...), and params whose
    values lead with S (``runtime.multistream``) — the S streams step as
    one batch: one vision pass (one K1 and one K3 launch) and one
    contraction (K2) for the S frames, each stream's recurrences with its
    own params, per-stream peaks in the audio tail (K4 with its stream
    axis), and every result leading with S."""
    mixing = params["spectrum_mixing"]
    with span("vaudio.step.vision"):
        hues, grads = extract_features(frame, carry.hues, mixing, cfg)
    with span("vaudio.step.synth"):
        phases = phase_accumulate(carry.phases, hues, cfg, consts)
        spectrum = build_spectrum(hues, grads, phases, carry.prev_spectrum,
                                  mixing, cfg, consts, filter_params=params)
    with span("vaudio.step.dsp"):
        pcm, ola_tail, running_max = synth_audio(
            spectrum, carry.ola_tail, carry.running_max, params, cfg,
            window)
    new_carry = StepCarry(hues=hues, phases=phases, prev_spectrum=spectrum,
                          ola_tail=ola_tail, running_max=running_max)
    out: Dict[str, Any] = {"pcm": pcm}
    if debug:
        out.update(hues=hues, grads=grads, spectrum=spectrum)
    return new_carry, out


def make_step(cfg: AuralizerConfig, debug: bool = False, jit: bool = True,
              device=None):
    """``step(carry, frame, params) -> (carry, out)`` with the synthesis
    constants and the window built once on ``device`` (the JAX package's
    ``make_step``).  ``frame`` is one (H, W, 3) frame, u8 or f32, on the
    host or the device; ``params`` live params as host values or as from
    :func:`params_to_device`.  ``jit`` is accepted and does nothing:
    PyTorch runs eagerly.  Every call returns new tensors and leaves the
    carry it was given untouched."""
    dev = pick_device(device)
    consts = SynthConstants.create(cfg, dev)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=dev)

    def step(carry, frame, params):
        batch = ({k: v[None] for k, v in frame.items()}
                 if isinstance(frame, dict) else frame[None])
        return frame_step(carry, frame_at(frames_to_device(batch, dev), 0),
                          params_to_device(params, cfg, dev), cfg, consts,
                          window, debug=debug)

    return step


def check_frames(frames):
    """A clip as tensors, not yet moved (a numpy array is shared, not
    copied): RGB (T, H, W, 3), or a dict ``{"y", "u", "v"}`` of planar
    YUV 4:2:0 (T, H, W), (T, H/2, W/2)."""
    if isinstance(frames, dict):
        planes = {k: _as_tensor(frames[k]) for k in ("y", "u", "v")}
        y = planes["y"]
        if y.ndim != 3 or any(planes[k].shape[0] != y.shape[0]
                              or planes[k].ndim != 3 for k in ("u", "v")):
            raise ValueError(f"expected YUV planes y [T, H, W], u and v "
                             f"[T, H/2, W/2]; got shapes "
                             f"{[tuple(p.shape) for p in planes.values()]}")
        return planes
    frames = _as_tensor(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected frames [T, H, W, 3]; got shape "
                         f"{tuple(frames.shape)}")
    return frames


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def num_frames(frames) -> int:
    """T of a clip: RGB frames or a dict of YUV planes."""
    return len(frames["y"] if isinstance(frames, dict) else frames)


def frame_at(frames, t: int):
    """Frame ``t`` of a clip: (H, W, 3), or a dict of its YUV planes."""
    if isinstance(frames, dict):
        return {k: v[t] for k, v in frames.items()}
    return frames[t]


def frames_slice(frames, start: int, end: int):
    """Frames ``start:end`` of a clip (each plane of a YUV dict)."""
    if isinstance(frames, dict):
        return {k: v[start:end] for k, v in frames.items()}
    return frames[start:end]


def frames_to_device(frames, device):
    """A clip as tensors on ``device``: RGB (T, H, W, 3), u8 staying u8
    and any other type becoming f32, or a dict of YUV planes, each moved
    as it is."""
    frames = check_frames(frames)
    first = frames["y"] if isinstance(frames, dict) else frames
    if first.device.type != "cpu" or torch.device(device).type == "cpu":
        return _frames_to(frames, device)
    with span("vaudio.ingest.frames"):                  # host to card
        return _frames_to(frames, device)


def _frames_to(frames, device):
    if isinstance(frames, dict):
        return {k: v.to(device) for k, v in frames.items()}
    if frames.dtype != torch.uint8:
        frames = frames.to(torch.float32)
    return frames.to(device)


def run_offline(frames, cfg: AuralizerConfig,
                params: Dict[str, Any] | None = None,
                carry: StepCarry | None = None, debug: bool = False,
                block: int = 1, device=None):
    """Sonify a whole clip frame by frame (the JAX package's ``lax.scan``
    as a Python loop), or, with ``block`` > 1, as blocked sub-chunks
    through :func:`vaudio_torch.runtime.chunked.blocked_pipeline`.

    Returns (audio f32[T*hop] or f32[T*hop, channels], final_carry,
    debug_dict of stacked per-frame hues/grads/spectra when ``debug``).
    """
    dev = pick_device(device)
    frames = frames_to_device(frames, dev)
    params = params_to_device(params, cfg, dev)
    carry = init_carry(cfg, dev) if carry is None \
        else carry_from_numpy(carry, dev)
    consts = SynthConstants.create(cfg, dev)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=dev)
    T = num_frames(frames)
    if block > 1 and T >= block:
        # Imported here: runtime.chunked imports this module.
        from vaudio_torch.runtime.chunked import blocked_pipeline, \
            chunk_pipeline
        main = T - T % block
        carry, out = blocked_pipeline(carry, frames_slice(frames, 0, main),
                                      params, cfg, consts, window,
                                      block=block, debug=debug)
        outs = [out]
        if T > main:
            carry, out = chunk_pipeline(carry, frames_slice(frames, main, T),
                                        params, cfg, consts, window,
                                        debug=debug)
            outs.append(out)
        outs = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    else:
        per_frame = []
        for t in range(T):
            carry, out = frame_step(carry, frame_at(frames, t), params,
                                    cfg, consts, window, debug=debug)
            per_frame.append(out)
        outs = {k: torch.stack([o[k] for o in per_frame])
                for k in per_frame[0]}
    audio = outs.pop("pcm")
    audio = audio.reshape(-1) if cfg.channels == 1 \
        else audio.reshape(-1, cfg.channels)
    return audio, carry, outs
