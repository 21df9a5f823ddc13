"""DSP-state checkpoint and resume — the PyTorch port of
:mod:`vaudio.runtime.checkpoint`.

The file format is the JAX package's: an ``.npz`` of the five carry fields
with their numpy dtypes and a ``carry_type`` marker, so that a carry saved
by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.runtime.step import StepCarry, init_carry

_FIELDS = ("hues", "phases", "prev_spectrum", "ola_tail", "running_max")


def carry_type_of(data) -> str | None:
    """The carry-class marker a checkpoint was saved with (``None`` for
    files from before the marker — always flagship StepCarry saves)."""
    if "carry_type" in data.files:
        return str(data["carry_type"])
    return None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path, carry) -> None:
    """Serialize a stream's DSP carry (any NamedTuple carry: the port's
    :class:`StepCarry`, of tensors on any device, or the JAX package's) to
    an ``.npz`` file.  ``path`` may be a path or a binary file object."""
    np.savez(path, carry_type=np.array(type(carry).__name__),
             **{f: _host(getattr(carry, f)) for f in type(carry)._fields})


def load_state(path, cfg: AuralizerConfig, device=None) -> StepCarry:
    """Restore a carry onto ``device`` (the card unless ``"cpu"`` is asked
    for), validating the marker, the fields and their shapes against
    ``cfg``.  ``path`` may be a path or a binary file object."""
    data = np.load(path)
    kind = carry_type_of(data)
    if kind not in (None, "StepCarry"):
        raise ValueError(
            f"checkpoint holds a {kind!r} carry, not the flagship "
            "StepCarry — saved by another model family?")
    missing = set(_FIELDS) - set(data.files)
    if missing:
        raise ValueError(
            f"checkpoint is missing flagship carry fields "
            f"{sorted(missing)} — saved by another model family?")
    dev = pick_device(device)
    ref = init_carry(cfg, "cpu")
    fields = {}
    for f in _FIELDS:
        arr = data[f]
        expect = tuple(getattr(ref, f).shape)
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"checkpoint field {f!r} has shape {arr.shape}, config "
                f"expects {expect} — wrong AuralizerConfig?")
        fields[f] = torch.as_tensor(np.array(arr), device=dev)
    return StepCarry(**fields)
