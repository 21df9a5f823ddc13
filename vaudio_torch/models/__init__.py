"""Model assemblies, the framework's model families — the PyTorch port of
:mod:`vaudio.models`.

* :class:`AuralizerModel` — the flagship 16-cell harmonic + Bessel
  pipeline (the reference's shipped design).
* :class:`OrthoModesModel` — the per-pixel A/Q/f0 synthesis family,
  reconstructed from the reference's abandoned design (SURVEY.md §2.9).
"""

from vaudio_torch.models.auralizer_model import AuralizerModel
from vaudio_torch.models.orthomodes import (ModeMultipliers, OrthoModesConfig,
                                            OrthoModesModel)

__all__ = ["AuralizerModel", "ModeMultipliers", "OrthoModesConfig",
           "OrthoModesModel"]
