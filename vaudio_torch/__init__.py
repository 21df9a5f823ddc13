"""vaudio_torch — the PyTorch/CUDA port of :mod:`vaudio`.

Same configuration (:class:`vaudio_torch.config.AuralizerConfig` and
:class:`~vaudio_torch.config.LiveParams`, copies of the JAX package's),
same layout and names as the JAX package, held to it by
``tests/test_torch_*.py``; every ``AuralizerConfig`` field runs, and RGB
frames (u8 or f32) or planar YUV 4:2:0 dicts ``{"y", "u", "v"}`` go in.
Both model families run: the flagship 16-cell model and the per-pixel
OrthoModes family (``models.orthomodes``, ``Auralizer(model="orthomodes")``).
Plain tensor code is PyTorch; the four kernels are hand-written CUDA C++
for Hopper (``csrc/``): the u8 mip pool with its interleaved and planar
entries (``ops.pool_kernel``), the Hann-peak spectrum contraction
(``ops.spectrum_kernel``), the vision epilogue (``ops.vision_kernel``) and
the AGC + overlap-add audio tail (``ops.audio_kernel``).  A CPU tensor runs
each kernel's plain PyTorch version.  The live stream's host runtime, the
audio ring and the read-ahead frame reader, is C++ (``native/``, built with
``g++`` at first use); the HTTP server (``runtime.server``) and the control
channel (``runtime.control``) serve a stream over the network.  The
serving pod (``runtime.MultiStreamAuralizer``) runs S streams of either
family through one stream-batched step a tick, one launch of each kernel
whatever S is, behind its HTTP panel (``runtime.PodServer``), which the
HTTP clients of ``vaudio_torch.client`` drive.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  Importing or running this package never imports jax
nor the JAX package ``vaudio``.
"""

from __future__ import annotations

import torch

from vaudio_torch.config import DEFAULT_CONFIG, AuralizerConfig, LiveParams

__version__ = "0.1.0"

# TF32 keeps ~3 decimal digits: an f32 matmul or convolution in TF32 would
# break every f32 band the port is held to (the GPU form of the TPU's
# bf16-DEFAULT trap, docs/PARITY.md "TPU matmul precision").
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


# Keyed by (key, device); never emptied (see device_constant).
_CONSTANTS: dict = {}


def device_constant(key, make, dev) -> torch.Tensor:
    """``make()`` (a host array) as a tensor on ``dev``, copied once per
    ``(key, dev)`` and kept for the life of the process.  A step captured
    in a CUDA graph (``runtime.step.GraphedStep``) reads such a constant
    at every replay through the address it had at the capture, so it is
    never freed; and the step copies nothing from the host."""
    k = (key, str(dev))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS.setdefault(k, torch.as_tensor(make(), device=dev))
    return t


__all__ = ["AuralizerConfig", "DEFAULT_CONFIG", "LiveParams", "__version__",
           "device"]
