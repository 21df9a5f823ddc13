"""Streaming-engine adapter — the PyTorch port of the flagship
:class:`vaudio.runtime.engine.AuralizerEngine`.

The stream (:mod:`vaudio_torch.runtime.stream`) owns the host loop; an
engine supplies what is specific to the model: the per-frame and per-chunk
step functions, the carry and the mapping from :class:`LiveParams` to the
step's parameters.  The contract is the JAX package's:

* ``make_step() -> step(carry, frame, params) -> (carry, out)``, with
  ``out["pcm"]`` one hop of samples and any other keys the debug surface;
* ``make_chunk_step() -> step(carry, frames[N], params)``, ``out["pcm"]``
  shaped ``[N, hop]``;
* ``carry_static``, ``init_carry``, ``params_arrays``, ``load_carry`` and
  ``carry_mismatch``;
* ``frame_error(frame, cfg) -> Optional[str]``, the network-ingest door's
  check of what this engine can run.
"""

from __future__ import annotations

from typing import Optional

from vaudio_torch import device as pick_device
from vaudio_torch import not_ported
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

    def make_step(self):
        from vaudio_torch.runtime.step import make_step
        return make_step(self.cfg, debug=self.debug, device=self.device)

    def make_chunk_step(self):
        from vaudio_torch.runtime.chunked import make_chunk_pipeline
        return make_chunk_pipeline(self.cfg, debug=self.debug,
                                   device=self.device)

    def init_carry(self, frame=None):
        from vaudio_torch.runtime.step import init_carry
        return init_carry(self.cfg, self.device)

    def params_arrays(self, live: LiveParams):
        return live.as_arrays()

    def load_carry(self, path):
        from vaudio_torch.runtime.checkpoint import load_state
        return load_state(path, self.cfg, device=self.device)

    def frame_error(self, frame, cfg=None) -> Optional[str]:
        from vaudio_torch.runtime.server import frame_structure_error
        return frame_structure_error(frame, cfg or self.cfg)

    def carry_mismatch(self, carry, frame) -> Optional[str]:
        """The flagship carry does not depend on the frame size."""
        return None


def make_engine(model: str, cfg: AuralizerConfig, debug: bool = False,
                device=None):
    """Engine factory by family name (the CLI's ``--model`` values)."""
    if model in (None, "auralizer"):
        return AuralizerEngine(cfg, debug=debug, device=device)
    if model == "orthomodes":
        raise not_ported("the orthomodes model")
    raise ValueError(f"unknown model family {model!r} "
                     "(auralizer, orthomodes)")
