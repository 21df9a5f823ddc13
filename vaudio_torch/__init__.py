"""vaudio_torch — the PyTorch/CUDA port of :mod:`vaudio`.

Same configuration (:class:`vaudio.config.AuralizerConfig`,
:class:`vaudio.config.LiveParams`), same layout and names as the JAX
package, held to it by ``tests/test_torch_*.py``.  Plain tensor code is
PyTorch; the two kernels on the chunk-batched path are hand-written CUDA C++
for Hopper (``csrc/``): the u8 mip pool (``ops.pool_kernel``) and the
Hann-peak spectrum contraction (``ops.spectrum_kernel``).  A CPU tensor runs
each kernel's plain PyTorch version.

Importing this package never imports jax.
"""

from __future__ import annotations

import torch

from vaudio.config import AuralizerConfig, LiveParams

# TF32 keeps ~3 decimal digits: an f32 matmul or convolution in TF32 would
# break every f32 band the port is held to (the GPU form of the TPU's
# bf16-DEFAULT trap, docs/PARITY.md "TPU matmul precision").
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Features outside the first slice, each with the ROADMAP item that ports
# it.  The AuralizerConfig flags among them are named as the fields are.
_NOT_PORTED = {
    "use_phase_lut": "queue 1 item 6.1",
    "use_matmul_irfft": "queue 1 item 6.2",
    "use_matmul_ema": "queue 1 item 6.3",
    "quantize_mips": "queue 1 item 6.4",
    "quantize_mips_int8": "queue 1 item 6.4",
    "planar YUV 4:2:0 frames": "queue 1 item 6.5",
    "the vision debug maps": "queue 1 item 6.6",
    "linear_cell_grads=False (the spatial gradient path)":
        "queue 1 item 6.7",
    "use_pallas_vision": "queue 2 K3",
    "use_pallas_audio": "queue 2 K4",
}


def device(spec=None) -> torch.device:
    """The device to run on: ``spec`` as given, else CUDA when present."""
    if spec is not None:
        return torch.device(spec)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def not_ported(feature: str) -> NotImplementedError:
    """The error for a feature outside the ported slice (a key of
    ``_NOT_PORTED``)."""
    return NotImplementedError(
        f"vaudio_torch does not port {feature} yet (ROADMAP.md "
        f"{_NOT_PORTED[feature]}); use the JAX package for it")


def check_config(cfg: AuralizerConfig) -> None:
    """Raise for any flag the port does not implement yet, never ignore it."""
    for name in _NOT_PORTED:
        if getattr(cfg, name, False):
            raise not_ported(name)
    if not cfg.linear_cell_grads:
        raise not_ported("linear_cell_grads=False (the spatial gradient "
                         "path)")


__all__ = ["AuralizerConfig", "LiveParams", "check_config", "device",
           "not_ported"]
