"""vaudio_torch — the PyTorch/CUDA port of :mod:`vaudio`.

Same configuration (:class:`vaudio_torch.config.AuralizerConfig` and
:class:`~vaudio_torch.config.LiveParams`, copies of the JAX package's),
same layout and names as the JAX package, held to it by
``tests/test_torch_*.py``.  Plain tensor code is PyTorch; the four kernels
are hand-written CUDA C++ for Hopper (``csrc/``): the u8 mip pool
(``ops.pool_kernel``), the Hann-peak spectrum contraction
(``ops.spectrum_kernel``), the vision epilogue (``ops.vision_kernel``) and
the AGC + overlap-add audio tail (``ops.audio_kernel``).  A CPU tensor runs
each kernel's plain PyTorch version.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  Importing or running this package never imports jax
nor the JAX package ``vaudio``.
"""

from __future__ import annotations

import torch

from vaudio_torch.config import AuralizerConfig, LiveParams

# TF32 keeps ~3 decimal digits: an f32 matmul or convolution in TF32 would
# break every f32 band the port is held to (the GPU form of the TPU's
# bf16-DEFAULT trap, docs/PARITY.md "TPU matmul precision").
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Features not ported yet, each with the ROADMAP item that ports it.  The
# AuralizerConfig flags among them are named as the fields are.
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
    "sonify(debug=True)": "queue 1 item 8",
    "inspect_frame": "queue 1 item 8",
    "attach_control (the live control channel)": "queue 1 item 9.3",
    "live_debug": "queue 1 item 9.3",
    "serve (the live HTTP server)": "queue 1 item 9.3",
    "the orthomodes model": "queue 1 item 10",
}


def device(spec=None) -> torch.device:
    """The device to run on: ``spec`` as given, else CUDA.  There is no
    quiet fall-back to the CPU: without a card, ask for ``"cpu"``."""
    if spec is not None:
        return torch.device(spec)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vaudio_torch runs on an NVIDIA GPU by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "run on the CPU")
    return torch.device("cuda")


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
