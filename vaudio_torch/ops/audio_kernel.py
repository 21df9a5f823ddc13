"""Kernel K4: the fused AGC + overlap-add audio tail, for one frame or a
chunk of T frames.

A frame's signal f32[nfft] (mono) or f32[C, nfft] (stereo, gains shared
across channels) -> (pcm f32[(C,) nfft / 2], new tail like the signal, new
running max f32[]): the attack/release peak EMA, the sigmoid normalisation,
the peak renormalisation, the window and the overlap-add.  It replaces the
TPU kernel ``vaudio/ops/audio_kernel.py::agc_overlap_add`` and the JAX
chunked tail that XLA runs (``vaudio/runtime/chunked.py:250-290``); the
CUDA source is ``csrc/audio_kernel.cu``, one launch per call at any T.

Every entry also takes S independent streams at once (the serving pod's
stream axis, ``runtime.multistream``): signals f32[S, T, (C,) nfft] (one
frame: f32[S, (C,) nfft]), tails f32[S, (C,) nfft] and running_max, attack
and release f32[S].  A stream axis is there when running_max has one
dimension (a single stream's is f32[]).  The kernel runs one cluster a
stream in one launch, and slot s equals a call on stream s alone, bit for
bit; a single stream is the S = 1 case of the same launch.  The plain
versions take S independent calls.

Two op orders, which round differently, each as its reference has it:

- the frame order (:func:`agc_overlap_add`, ``frame_step``, and
  :func:`agc_overlap_add_frames`, T frames of it in one launch for the
  OrthoModes chunk step): the TPU kernel's, ``x / (peak / norm)``, as the
  unfused ``dsp.core.agc_normalize`` + ``overlap_add``.
- the chunk order (:func:`agc_overlap_add_chunk`, ``chunk_pipeline``): the
  JAX chunked tail's, ``x * (1 / (peak / norm))``.

The plain versions' sigmoid divides by ``g1 - g0`` rounded once from f64;
the kernel, as the TPU kernel, subtracts the f32-rounded bounds.  Both give
the same f32 value.

Both wrappers route by device: a CPU tensor runs the plain version, a CUDA
tensor the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch.dsp.core import sigmoid_normalize
from vaudio_torch.ops import _build

#: Wrapper calls that launched the kernel (a run resets it to 0 and reads
#: it after): one per frame or chunk.
launches = 0

# The sigmoid bounds g(0) and g(1) as the TPU kernel folds them: each
# rounded to f32 once, their difference an f32 subtraction
# (vaudio/ops/audio_kernel.py:51-53).
_G0 = np.float32(1.0 / (1.0 + np.exp(1.0)))
_G1 = np.float32(1.0 / (1.0 + np.exp(-1.0)))
_G1_MINUS_G0 = np.float32(_G1 - _G0)
_PEAK_EPS = float(np.float32(1e-9))
_GAIN_EPS = float(np.float32(1e-6))
_FRAME_ORDER, _CHUNK_ORDER = 0, 1       # the kernel's op orders


def _per_stream(plain, signals, ola_tail, window, running_max, attack,
                release):
    """``plain`` on each stream of a stream axis alone, the results
    stacked: S independent calls."""
    outs = [plain(signals[s], ola_tail[s], window, running_max[s], attack[s],
                  release[s]) for s in range(signals.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def agc_overlap_add_plain(signal, ola_tail, window, running_max, attack,
                          release):
    """The plain PyTorch version of one frame, in the TPU kernel's op
    order."""
    if running_max.dim() == 1:
        return _per_stream(agc_overlap_add_plain, signal, ola_tail, window,
                           running_max, attack, release)
    frame_peak = torch.amax(torch.abs(signal)) + _PEAK_EPS
    attacked = attack * frame_peak + (1.0 - attack) * running_max
    released = release * frame_peak + (1.0 - release) * running_max
    new_max = torch.where(frame_peak > running_max, attacked, released)
    norm = torch.clamp(sigmoid_normalize(frame_peak, new_max), 0.0, 1.0)
    normalized = signal / (frame_peak / norm)
    normalized = torch.where(torch.isfinite(normalized), normalized,
                             torch.zeros_like(normalized))
    gain = 1.0 / (torch.amax(torch.abs(normalized)) + _GAIN_EPS)
    windowed = normalized * gain * window
    hop = signal.shape[-1] // 2
    return ola_tail[..., hop:] + windowed[..., :hop], windowed, new_max


def agc_overlap_add_frames_plain(signals, ola_tail, window, running_max,
                                 attack, release):
    """The plain PyTorch version of :func:`agc_overlap_add_frames`: T
    chained calls of :func:`agc_overlap_add_plain`, the pcm stacked in the
    kernel's layout."""
    if running_max.dim() == 1:
        return _per_stream(agc_overlap_add_frames_plain, signals, ola_tail,
                           window, running_max, attack, release)
    pcm = []
    for signal in signals:
        hop_pcm, ola_tail, running_max = agc_overlap_add_plain(
            signal, ola_tail, window, running_max, attack, release)
        pcm.append(hop_pcm if signal.ndim == 1 else hop_pcm.T)
    return torch.stack(pcm), ola_tail, running_max


def agc_overlap_add_chunk_plain(signals, ola_tail, window, running_max,
                                attack, release):
    """The plain PyTorch version of a chunk, in the chunk order: the
    per-frame peaks batched, the running-max recurrence a Python loop, the
    samples batched, as the JAX package writes its chunked tail."""
    if running_max.dim() == 1:
        return _per_stream(agc_overlap_add_chunk_plain, signals, ola_tail,
                           window, running_max, attack, release)
    T = signals.shape[0]
    axes = tuple(range(1, signals.ndim))
    peaks = torch.amax(torch.abs(signals), dim=axes) + 1e-9
    rm = running_max
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

    hop = signals.shape[-1] // 2
    fpeaks = torch.amax(torch.abs(normalized), dim=axes)
    gains = 1.0 / (fpeaks + 1e-6)
    windowed = normalized * gains.reshape(bshape) * window
    prev_tails = torch.cat([ola_tail[None], windowed[:-1]])
    pcm = prev_tails[..., hop:] + windowed[..., :hop]
    if signals.ndim == 3:
        pcm = pcm.transpose(1, 2)                       # (T, hop, channels)
    return pcm, windowed[-1], rm


def _launch(signals, ola_tail, window, running_max, attack, release,
            order: int, what: str):
    """One launch of the kernel on S streams of T frames: signals f32[S, T,
    (C,) nfft], ola_tail f32[S, (C,) nfft], running_max, attack and release
    f32[S]; returns (pcm f32[S, T, hop(, C)], new tails, new running maxes
    f32[S])."""
    _build.require_cuda(signals, what)
    global launches
    dev = signals.device
    nfft = signals.shape[-1]
    if signals.ndim not in (3, 4):
        raise ValueError(f"{what}: the kernel takes f32[S, T, nfft] or "
                         f"f32[S, T, C, nfft]; got {tuple(signals.shape)}")
    S, T = signals.shape[:2]
    for name, x, shape in (("signals", signals, tuple(signals.shape)),
                           ("ola_tail", ola_tail,
                            (S,) + tuple(signals.shape[2:])),
                           ("window", window, (nfft,)),
                           ("running_max", running_max, (S,)),
                           ("attack", attack, (S,)),
                           ("release", release, (S,))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous f32 tensor of shape "
                f"{shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    C = 1 if signals.ndim == 3 else signals.shape[2]
    if S < 1 or T < 1 or C not in (1, 2) or nfft % 2:
        raise ValueError(f"{what}: the kernel takes S >= 1 streams of "
                         f"T >= 1 frames, C = 1 or 2 and nfft even; got "
                         f"{tuple(signals.shape)}")
    pcm = torch.empty((S, T, nfft // 2) + ((C,) if signals.ndim == 4
                                           else ()),
                      dtype=torch.float32, device=dev)
    new_tail = torch.empty_like(ola_tail)
    new_max = torch.empty((S,), dtype=torch.float32, device=dev)
    err = _build.lib().vaudio_agc_overlap_add(
        signals.data_ptr(), ola_tail.data_ptr(), window.data_ptr(),
        running_max.data_ptr(), attack.data_ptr(), release.data_ptr(),
        pcm.data_ptr(), new_tail.data_ptr(), new_max.data_ptr(), S, T, C,
        nfft, order, float(_G0), float(_G1_MINUS_G0),
        _build.stream_ptr(dev))
    _build.check(err, what)
    launches += 1
    return pcm, new_tail, new_max


def _launch_one_or_streams(signals, ola_tail, window, running_max, attack,
                           release, order: int, what: str):
    """:func:`_launch` on a stream axis as given (running_max f32[S]), or
    on a single stream as the S = 1 case: its results without the
    axis."""
    if running_max.dim() == 1:
        return _launch(signals, ola_tail, window, running_max,
                       attack.contiguous(), release.contiguous(), order,
                       what)
    pcm, new_tail, new_max = _launch(
        signals[None], ola_tail[None], window, running_max.reshape(1),
        attack.reshape(1), release.reshape(1), order, what)
    return pcm[0], new_tail[0], new_max[0]


def agc_overlap_add(signal, ola_tail, window, running_max, attack, release):
    """One frame, in the frame order: signal and ola_tail f32[nfft] or
    f32[C, nfft], window f32[nfft], running_max / attack / release f32
    scalars -> (pcm f32[(C,) nfft/2], new_tail, new_running_max f32[]).
    With a stream axis (module docstring) every result leads with S.
    On CUDA the stereo pcm is a (C, nfft/2) view of the kernel's
    (nfft/2, C) output."""
    if signal.device.type == "cpu":
        return agc_overlap_add_plain(signal, ola_tail, window, running_max,
                                     attack, release)
    pod = running_max.dim() == 1
    pcm, new_tail, new_max = _launch_one_or_streams(
        signal[:, None] if pod else signal[None], ola_tail, window,
        running_max, attack, release, _FRAME_ORDER, "agc_overlap_add")
    pcm = pcm[:, 0] if pod else pcm[0]
    return (pcm if signal.ndim == 1 + pod else pcm.transpose(-1, -2)), \
        new_tail, new_max


def agc_overlap_add_frames(signals, ola_tail, window, running_max, attack,
                           release):
    """T frames in the frame order, as T chained :func:`agc_overlap_add`
    calls give them, in one launch: signals f32[T, nfft] or f32[T, C,
    nfft], ola_tail the carried tail f32[(C,) nfft], window f32[nfft],
    running_max / attack / release f32 scalars -> (pcm f32[T, nfft/2] or
    f32[T, nfft/2, C], the new tail, the new running max f32[]).  With a
    stream axis (module docstring) every result leads with S."""
    if signals.device.type == "cpu":
        return agc_overlap_add_frames_plain(signals, ola_tail, window,
                                            running_max, attack, release)
    return _launch_one_or_streams(signals, ola_tail, window, running_max,
                                  attack, release, _FRAME_ORDER,
                                  "agc_overlap_add_frames")


def agc_overlap_add_chunk(signals, ola_tail, window, running_max, attack,
                          release):
    """T frames, in the chunk order: signals f32[T, nfft] or f32[T, C,
    nfft], ola_tail the carried tail f32[(C,) nfft], window f32[nfft],
    running_max / attack / release f32 scalars -> (pcm f32[T, nfft/2] or
    f32[T, nfft/2, C], the new tail, the new running max f32[]).  With a
    stream axis (module docstring) every result leads with S."""
    if signals.device.type == "cpu":
        return agc_overlap_add_chunk_plain(signals, ola_tail, window,
                                           running_max, attack, release)
    return _launch_one_or_streams(signals, ola_tail, window, running_max,
                                  attack, release, _CHUNK_ORDER,
                                  "agc_overlap_add_chunk")
