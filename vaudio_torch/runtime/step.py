"""The per-frame frame->audio step and its offline loop — the PyTorch port
of :mod:`vaudio.runtime.step`.

The recurrent DSP state is an explicit :class:`StepCarry` of tensors with
the JAX package's fields and shapes; ``lax.scan`` becomes a Python loop.
Where ``jax.jit`` compiles the step, the live stream's and the pod's step
(:class:`GraphedStep`) replays it on a card as a captured CUDA graph.
"""

from __future__ import annotations

import collections
import sys
import threading
import traceback
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp.core import (agc_normalize, hann_window_norm,
                                   irfft_from_half, irfft_from_half_dense,
                                   overlap_add)
from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                              vision_kernel)
from vaudio_torch.ops.audio_kernel import agc_overlap_add
from vaudio_torch.runtime.ingest import (check_frames, frame_at,
                                         frames_slice, num_frames, to_device)
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
    :func:`params_to_device`.  Once the frame is on the device the step is
    a :class:`GraphedStep`: a captured CUDA graph replayed on a card, and
    eager on the CPU, with the same bits either way;
    ``step.counts()`` gives its counters.  ``jit`` is accepted and does
    nothing.  Every call returns new tensors and leaves the carry it was
    given untouched."""
    graphed = GraphedStep(cfg, device, debug=debug)

    def step(carry, frame, params):
        batch = ({k: v[None] for k, v in frame.items()}
                 if isinstance(frame, dict) else frame[None])
        batch = to_device(check_frames(batch), graphed.device)
        return graphed(carry, frame_at(batch, 0), params)

    step.counts = graphed.counts
    return step


#: The kernels' launch counters, (module, attribute) each: a replay adds
#: what its capture counted, so that they count the launches that ran.
LAUNCH_COUNTERS = ((pool_kernel, "launches"),
                   (pool_kernel, "planar_launches"),
                   (pool_kernel, "yuv_launches"),
                   (spectrum_kernel, "launches"),
                   (vision_kernel, "launches"),
                   (audio_kernel, "launches"))


def _launch_counts():
    return [getattr(m, name) for m, name in LAUNCH_COUNTERS]


def _add_launches(counts) -> None:
    for (m, name), n in zip(LAUNCH_COUNTERS, counts):
        setattr(m, name, getattr(m, name) + n)


#: The counters of a :class:`GraphedStep` (:meth:`GraphedStep.counts`).
STEP_COUNTS = ("graph_captures", "graph_replays", "eager_steps")


def step_counts(step) -> Dict[str, int]:
    """The counters of ``step`` (:meth:`GraphedStep.counts`, carried by
    :func:`make_step`'s step too); zeros for a step without them."""
    counts = getattr(step, "counts", None)
    return counts() if counts is not None else dict.fromkeys(STEP_COUNTS, 0)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def step_signature(carry: StepCarry, frame, params: Dict[str, Any],
                   device) -> tuple:
    """What a captured :func:`frame_step` is specific to: the frame's
    layout (an RGB tensor or a dict of YUV planes), shapes and dtypes; the
    stream axis S (None for a single stream) and the carry's shapes and
    dtypes; the params' keys and dims; the device."""
    if isinstance(frame, dict):
        layout = ("yuv",) + tuple((k, tuple(v.shape), v.dtype)
                                  for k, v in sorted(frame.items()))
    else:
        layout = ("rgb", tuple(frame.shape), frame.dtype)
    rm = carry.running_max
    return (layout, rm.shape[0] if rm.dim() == 1 else None,
            tuple((tuple(x.shape), x.dtype) for x in carry),
            tuple(sorted((k, _shape(v)) for k, v in params.items())),
            torch.device(device))


def _empty_like(x):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


class _Captured:
    """One signature's CUDA graph: the static inputs, which every replay
    first fills, and the outputs, which every replay overwrites."""

    def __init__(self, carry: StepCarry, frame, params: Dict[str, Any],
                 device):
        self.graph = torch.cuda.CUDAGraph()
        self.frame = ({k: _empty_like(v) for k, v in frame.items()}
                      if isinstance(frame, dict) else _empty_like(frame))
        self.carry = StepCarry(*(_empty_like(x) for x in carry))
        shapes = {k: _shape(v) for k, v in params.items()}
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes.values()]
        # Every param a view of one buffer, which one copy fills.
        self.packed = torch.empty(sum(sizes), dtype=torch.float32,
                                  device=device)
        self.params, at = {}, 0
        for (k, shape), n in zip(shapes.items(), sizes):
            self.params[k] = self.packed[at:at + n].view(shape)
            at += n
        self.out = None             # (carry, out) of the captured step
        self.launches = None        # the kernels' launches of one replay

    def fill(self, carry: StepCarry, frame, params: Dict[str, Any]) -> None:
        """Copy a call's inputs into the static buffers, on the current
        stream, so after the previous replay: the params' host values in
        one page-locked copy, the frame and the carry device to device."""
        if any(isinstance(v, torch.Tensor) for v in params.values()):
            for k, v in params.items():
                self.params[k].copy_(torch.as_tensor(v))
        else:
            with span("vaudio.ingest.params"):
                host = np.concatenate([np.asarray(params[k], np.float32)
                                       .ravel() for k in self.params])
                self.packed.copy_(torch.from_numpy(host).pin_memory(),
                                  non_blocking=True)
        if isinstance(frame, dict):
            for k, v in frame.items():
                self.frame[k].copy_(v)
        else:
            self.frame.copy_(frame)
        for static, x in zip(self.carry, carry):
            static.copy_(x)


class GraphedStep:
    """:func:`frame_step` with its synthesis constants and window built
    once on ``device`` (the card unless given), as ``step(carry, frame,
    params) -> (carry, out)``: ``frame`` on the device, one (H, W, 3)
    frame or a dict of its YUV planes, or with a stream axis one frame of
    each of S streams (:func:`frame_step`); ``params`` host values or
    tensors.

    On a CUDA device, the first call of each input signature
    (:func:`step_signature`) runs the step eagerly on a side stream,
    returns that result and captures the step on the same stream as a CUDA
    graph.  Every later call of the signature copies its inputs into the
    graph's static buffers, replays the graph (span ``vaudio.step.replay``)
    and returns copies of the outputs (with ``debug`` the hues, gradients
    and spectrum too), so that a result outlives the next replay and the
    caller's carry is never written.  A replay launches the eager step's
    kernels in its order with its arguments, so its bits are the eager
    step's; the kernels' launch counters (:data:`LAUNCH_COUNTERS`) count
    each replay's launches.  The newest :attr:`KEEP` signatures keep their
    graphs.  On the CPU every call runs eagerly (:meth:`eager`); so does a
    signature whose capture failed, which says so once on stderr.  Calls
    are serialised by a lock."""

    #: Signatures whose graphs are kept: a shape that flaps between two
    #: values captures twice, a third signature frees the oldest graph.
    KEEP = 2

    def __init__(self, cfg: AuralizerConfig, device=None,
                 debug: bool = False):
        self.cfg = cfg
        self.device = pick_device(device)
        self.debug = debug
        self.consts = SynthConstants.create(cfg, self.device)
        self.window = torch.as_tensor(hann_window_norm(cfg.nfft),
                                      device=self.device)
        self.graph_captures = self.graph_replays = self.eager_steps = 0
        # signature -> _Captured, or None where the capture failed
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._stream = None         # the side stream of every capture
        self._lock = threading.Lock()

    @property
    def graphed(self) -> bool:
        """Whether calls capture and replay graphs: on a CUDA device."""
        return self.device.type == "cuda"

    def counts(self) -> Dict[str, int]:
        """Calls that captured a graph, that replayed one, and that ran
        eagerly."""
        return {"graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "eager_steps": self.eager_steps}

    def eager(self, carry: StepCarry, frame, params: Dict[str, Any]):
        """The step run eagerly (the mesh steps of ``parallel`` take
        it)."""
        return frame_step(carry, frame,
                          params_to_device(params, self.cfg, self.device),
                          self.cfg, self.consts, self.window,
                          debug=self.debug)

    def __call__(self, carry: StepCarry, frame, params: Dict[str, Any]):
        if params is None:
            params = default_params(self.cfg)
        if not self.graphed:
            with self._lock:
                self.eager_steps += 1
            return self.eager(carry, frame, params)
        sig = step_signature(carry, frame, params, self.device)
        with self._lock, torch.cuda.device(self.device):
            if sig not in self._graphs:
                return self._capture(sig, carry, frame, params)
            self._graphs.move_to_end(sig)
            g = self._graphs[sig]
            if g is None:
                self.eager_steps += 1
                return self.eager(carry, frame, params)
            with span("vaudio.step.replay"):
                g.fill(carry, frame, params)
                g.graph.replay()
                new = StepCarry(*(x.clone() for x in g.out[0]))
                out = {k: v.clone() for k, v in g.out[1].items()}
            _add_launches(g.launches)
            self.graph_replays += 1
            return new, out

    def _run(self, g: _Captured):
        return frame_step(g.carry, g.frame, g.params, self.cfg, self.consts,
                          self.window, debug=self.debug)

    def _capture(self, sig, carry: StepCarry, frame, params):
        """The eager step on the static inputs, on the side stream (its
        result is this call's), then the capture on the same stream."""
        g = _Captured(carry, frame, params, self.device)
        g.fill(carry, frame, params)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        side, current = self._stream, torch.cuda.current_stream()
        side.wait_stream(current)
        # The outer context restores the caller's stream even where a
        # failed capture leaves the graph's own context open.
        with torch.cuda.stream(side):
            new, out = self._run(g)
            before = _launch_counts()
            try:
                with torch.cuda.graph(g.graph, stream=side,
                                      capture_error_mode="thread_local"):
                    g.out = self._run(g)
                self.graph_captures += 1
            except Exception:
                # A stream must keep running: this signature runs eagerly.
                g = None
                self.eager_steps += 1
                print("vaudio_torch: capturing the step as a CUDA graph "
                      "failed; its input signature runs eagerly:\n"
                      + traceback.format_exc(), file=sys.stderr)
            finally:
                # The capture launched nothing: replays count its launches.
                counted = [a - b for a, b in zip(_launch_counts(), before)]
                _add_launches([-n for n in counted])
        current.wait_stream(side)
        for x in (*new, *out.values()):
            x.record_stream(current)
        if g is not None:
            g.launches = counted
        self._graphs[sig] = g
        while len(self._graphs) > self.KEEP:
            if self._graphs.popitem(last=False)[1] is not None:
                current.synchronize()    # its last replay has ended
        return new, out


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
    frames = to_device(check_frames(frames), dev)
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
