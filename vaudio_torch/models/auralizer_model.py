"""The flagship model: the whole video -> audio pipeline as one object —
the PyTorch port of :mod:`vaudio.models.auralizer_model`.

``AuralizerModel`` bundles the configuration, the step with its synthesis
constants on one device and the state factory, so that callers get one
handle; the pipeline itself is :func:`vaudio_torch.runtime.step.frame_step`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.runtime.step import (StepCarry, default_params, init_carry,
                                       make_step)


class AuralizerModel:
    """Config + step + state factory for one video resolution, on one
    device (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, config: Optional[AuralizerConfig] = None,
                 debug: bool = False, device=None):
        self.config = config or AuralizerConfig()
        self.device = pick_device(device)
        self.step = make_step(self.config, debug=debug, device=self.device)
        # The JAX package's unjitted twin: a replay of the step's CUDA graph
        # gives the eager step's bits, so it is the same step.
        self.eager_step = self.step

    def init_state(self) -> StepCarry:
        return init_carry(self.config, self.device)

    def default_params(self) -> Dict[str, np.float32]:
        return default_params(self.config)

    def example_inputs(self, height: int = 1080, width: int = 1920
                       ) -> Tuple[StepCarry, torch.Tensor, Dict]:
        frame = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=self.device)
        return self.init_state(), frame, self.default_params()

    def __call__(self, carry, frame, params):
        return self.step(carry, frame, params)
