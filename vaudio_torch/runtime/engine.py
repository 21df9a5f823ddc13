"""Streaming-engine adapters — the PyTorch port of
:mod:`vaudio.runtime.engine`: the flagship :class:`AuralizerEngine` and
the per-pixel :class:`OrthoModesEngine`.

The stream (:mod:`vaudio_torch.runtime.stream`) owns the host loop; an
engine supplies what is specific to the model: the per-frame and per-chunk
step functions, the carry and the mapping from :class:`LiveParams` to the
step's parameters.  The contract is the JAX package's:

* ``make_step() -> step(carry, frame, params) -> (carry, out)``, with
  ``out["pcm"]`` one hop of samples and any other keys the debug surface;
* ``make_chunk_step() -> step(carry, frames[N], params)``, ``out["pcm"]``
  shaped ``[N, hop]``;
* ``carry_static`` (False: the carry is sized by the frame, built at the
  first dispatch and rebuilt after a resolution change), ``init_carry``,
  ``carry_from_numpy`` (a carry of either package, tensors or numpy, as
  this engine's carry type on its device), ``params_arrays``,
  ``load_carry`` and ``carry_mismatch``;
* ``frame_error(frame, cfg) -> Optional[str]``, the network-ingest door's
  check of what this engine can run;
* for the serving pod (:mod:`vaudio_torch.runtime.multistream`):
  ``raw_step()`` and ``raw_chunk_step()``, the step over S streams at once
  (frames on the engine's device with a leading stream axis, a carry and
  params whose values lead with S), ``init_carry_batch(n, frame)`` and
  ``load_carry_batch(path, n)``.  Where the JAX package ``vmap``s its
  one-stream step, these are the port's stream-batched steps;
  ``on_device(device)`` gives the engine on a mesh shard's device
  (:mod:`vaudio_torch.parallel`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig, LiveParams


class AuralizerEngine:
    """The flagship 16-cell model on one device (the card unless ``"cpu"``
    is asked for)."""

    name = "auralizer"
    carry_static = True

    def __init__(self, cfg: AuralizerConfig, debug: bool = False,
                 device=None):
        self.cfg = cfg
        self.debug = debug
        self.device = pick_device(device)

    def on_device(self, device) -> "AuralizerEngine":
        """This engine on ``device`` (a mesh shard's, ``parallel``)."""
        return AuralizerEngine(self.cfg, debug=self.debug, device=device)

    def make_step(self):
        from vaudio_torch.runtime.step import make_step
        return make_step(self.cfg, debug=self.debug, device=self.device)

    def make_chunk_step(self):
        from vaudio_torch.runtime.chunked import make_chunk_pipeline
        return make_chunk_pipeline(self.cfg, debug=self.debug,
                                   device=self.device)

    def _batched(self, fn, debug: bool):
        """``step(carry, frames, params)`` running ``fn`` (frame_step or
        chunk_pipeline) on a stream axis, with the constants and the
        window built once on the engine's device."""
        from vaudio_torch.dsp.core import hann_window_norm
        from vaudio_torch.runtime.step import params_to_device
        from vaudio_torch.synth.spectrum import SynthConstants
        cfg, dev = self.cfg, self.device
        consts = SynthConstants.create(cfg, dev)
        window = torch.as_tensor(hann_window_norm(cfg.nfft), device=dev)

        def step(carry, frames, params):
            return fn(carry, frames, params_to_device(params, cfg, dev), cfg,
                      consts, window, debug=debug)
        return step

    def raw_step(self):
        """``step(carry, frames, params)`` over a pod's S streams: one
        frame a stream, (S, H, W, 3) or planes (S, ...), through the
        stream-batched :func:`runtime.step.frame_step`."""
        from vaudio_torch.runtime.step import frame_step
        return self._batched(frame_step, self.debug)

    def raw_chunk_step(self):
        """``step(carry, frames, params)`` over a pod's S streams of N
        frames, (S, N, H, W, 3) or planes (S, N, ...), through the
        stream-batched :func:`runtime.chunked.chunk_pipeline`."""
        from vaudio_torch.runtime.chunked import chunk_pipeline
        return self._batched(chunk_pipeline, False)

    def init_carry(self, frame=None):
        from vaudio_torch.runtime.step import init_carry
        return init_carry(self.cfg, self.device)

    def init_carry_batch(self, n: int, frame=None):
        """:meth:`init_carry` broadcast to ``n`` streams (every field gains
        a leading stream axis)."""
        return _batch(self.init_carry(), n)

    def carry_from_numpy(self, carry):
        from vaudio_torch.runtime.step import carry_from_numpy
        return carry_from_numpy(carry, self.device)

    def params_arrays(self, live: LiveParams):
        return live.as_arrays()

    def load_carry(self, path):
        from vaudio_torch.runtime.checkpoint import load_state
        return load_state(path, self.cfg, device=self.device)

    def load_carry_batch(self, path, n: int):
        """A pod checkpoint of ``n`` streams (either package's ``.npz``)."""
        from vaudio_torch.runtime.checkpoint import load_state
        return load_state(path, self.cfg, n_streams=n, device=self.device)

    def frame_error(self, frame, cfg=None) -> Optional[str]:
        from vaudio_torch.runtime.server import frame_structure_error
        return frame_structure_error(frame, cfg or self.cfg)

    def carry_mismatch(self, carry, frame) -> Optional[str]:
        """The flagship carry does not depend on the frame size."""
        return None


def _batch(carry, n: int):
    """``carry`` repeated for ``n`` streams: each field gains a leading
    stream axis."""
    return type(carry)(*(x.expand((n,) + x.shape).contiguous()
                         for x in carry))


def _frame_hw(frame):
    """(H, W) of an RGB frame or of a dict of YUV planes."""
    if isinstance(frame, dict):
        return tuple(np.shape(frame["y"]))[:2]
    return tuple(np.shape(frame))[:2]


class OrthoModesEngine:
    """The per-pixel OrthoModes family behind the same streaming loop, on
    one device (the card unless ``"cpu"`` is asked for).

    Wraps :class:`vaudio_torch.models.OrthoModesModel`: the carry (one
    phase per mip pixel) is sized by the first frame; the chunk step pools
    its frames in one K1 launch and ends in one K4 launch; LiveParams maps
    to ``{mode multipliers, spectrum_mixing, attack, release}``.  The model
    is mono and RGB-only, so the config is coerced to one channel and no
    filters (vaudio/runtime/engine.py:144-148)."""

    name = "orthomodes"
    carry_static = False

    def __init__(self, cfg: AuralizerConfig, debug: bool = False,
                 model_cfg=None, multipliers=None, device=None):
        from vaudio_torch.models import OrthoModesConfig, OrthoModesModel
        if cfg.channels != 1:
            cfg = dataclasses.replace(cfg, channels=1)
        if cfg.enable_filters:
            cfg = dataclasses.replace(cfg, enable_filters=False)
        self.cfg = cfg
        self.debug = debug
        if model_cfg is None:
            model_cfg = OrthoModesConfig(audio=cfg)
        self.model = OrthoModesModel(model_cfg, multipliers=multipliers,
                                     device=device)
        self.device = self.model.device

    def on_device(self, device) -> "OrthoModesEngine":
        """This engine, its model config and multipliers, on ``device`` (a
        mesh shard's, ``parallel``)."""
        return OrthoModesEngine(self.cfg, debug=self.debug,
                                model_cfg=self.model.cfg,
                                multipliers=self.model.multipliers,
                                device=device)

    # -- step functions ------------------------------------------------------

    def make_step(self):
        """``step(carry, frame, params) -> (carry, out)``: one frame, host
        or device; with ``debug`` also the spectrum (the per-pixel family
        has no cell hues or gradients).  On a stream axis (the pod's
        :meth:`raw_step`) one frame of each of S streams, every result
        leading with S."""
        def step(carry, frame, params):
            carry, pcm = self.model.frame_step(carry, frame, params)
            out = {"pcm": pcm}
            if self.debug:
                out["spectrum"] = carry.prev_spectrum
            return carry, out
        return step

    raw_step = make_step

    def make_chunk_step(self):
        """``step(carry, frames[N], params) -> (carry, out)``, out["pcm"]
        f32[N, hop] (and the N spectra with ``debug``); on a stream axis
        (the pod's :meth:`raw_chunk_step`) frames (S, N, H, W, 3)."""
        def step(carry, frames, params):
            carry, pcm, spectra = self.model.chunk_step(carry, frames,
                                                        params)
            out = {"pcm": pcm}
            if self.debug:
                out["spectrum"] = spectra
            return carry, out
        return step

    raw_chunk_step = make_chunk_step

    # -- carry ---------------------------------------------------------------

    def init_carry(self, frame=None):
        if frame is None:
            raise ValueError(
                "the OrthoModes carry is sized by the frame (one "
                "oscillator per mip pixel) — no frames seen yet")
        return self.model.init_carry(
            self.model.num_oscillators(*_frame_hw(frame)))

    def init_carry_batch(self, n: int, frame=None):
        """The frame-sized carry of :meth:`init_carry` for ``n`` streams."""
        return _batch(self.init_carry(frame), n)

    def carry_from_numpy(self, carry):
        from vaudio_torch.models.orthomodes import carry_from_numpy
        return carry_from_numpy(carry, self.device)

    def params_arrays(self, live: LiveParams):
        return {**self.model.multipliers.as_arrays(),
                "spectrum_mixing": np.float32(live.spectrum_mixing),
                "attack": np.float32(live.attack),
                "release": np.float32(live.release)}

    def load_carry(self, path):
        """An OrthoModes checkpoint (either package's ``.npz``) on this
        engine's device; the oscillator count is checked against the first
        frame (:meth:`carry_mismatch`)."""
        return self._load(path, (self.cfg.num_bins, 2),
                          "wrong AuralizerConfig")

    def load_carry_batch(self, path, n: int):
        """A pod checkpoint of ``n`` OrthoModes streams."""
        return self._load(path, (n, self.cfg.num_bins, 2),
                          "wrong pod size or model config")

    def _load(self, path, expect, what: str):
        from vaudio_torch.models.orthomodes import OrthoCarry
        from vaudio_torch.runtime.checkpoint import carry_type_of
        data = np.load(path)
        kind = carry_type_of(data)
        if kind != "OrthoCarry":
            raise ValueError(
                f"checkpoint holds a {kind or 'flagship StepCarry'} "
                "carry, not the OrthoModes per-pixel carry — saved by "
                "another model family?")
        missing = set(OrthoCarry._fields) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint is missing OrthoModes carry fields "
                f"{sorted(missing)} — a flagship-model checkpoint?")
        if tuple(data["prev_spectrum"].shape) != expect:
            raise ValueError(
                f"checkpoint prev_spectrum shape "
                f"{data['prev_spectrum'].shape}, expected {expect} — "
                f"{what}?")
        return self.carry_from_numpy(data)

    def frame_error(self, frame, cfg=None) -> Optional[str]:
        from vaudio_torch.runtime.server import frame_structure_error
        if isinstance(frame, dict):
            return ("the OrthoModes family is RGB-only (the reference "
                    "kernel predates the planar-YUV path); send "
                    "(H, W, 3) frames")
        err = frame_structure_error(frame, None)
        if err is not None:
            return err
        h, w = _frame_hw(frame)
        level = self.model.cfg.mip_level
        if (h >> level) < 1 or (w >> level) < 1:
            return (f"frame {h}x{w} is too small for the level-{level} "
                    "per-pixel mip (no oscillators left)")
        return None

    def carry_mismatch(self, carry, frame) -> Optional[str]:
        """A restore happens before any frame is seen, so the first
        dispatch checks the restored carry's oscillator count against the
        frame: a clear error instead of a broadcast failure in the step."""
        h, w = _frame_hw(frame)
        need = self.model.num_oscillators(h, w)
        got = int(carry.phases.shape[-1])
        if got != need:
            return (f"restored OrthoModes carry holds {got} oscillators "
                    f"but {h}x{w} frames at mip level "
                    f"{self.model.cfg.mip_level} need {need} — "
                    "checkpoint from a different input resolution?")
        return None


def make_engine(model: str, cfg: AuralizerConfig, debug: bool = False,
                device=None):
    """Engine factory by family name (the CLI's ``--model`` values)."""
    if model in (None, "auralizer"):
        return AuralizerEngine(cfg, debug=debug, device=device)
    if model == "orthomodes":
        return OrthoModesEngine(cfg, debug=debug, device=device)
    raise ValueError(f"unknown model family {model!r} "
                     "(auralizer, orthomodes)")
