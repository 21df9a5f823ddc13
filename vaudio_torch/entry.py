"""The forward step on the flagship model at 1080p — the port's
counterpart of the JAX package's ``__graft_entry__.entry``.

    fn, args = entry()          # on the card (entry(device="cpu") on the CPU)
    carry, out = fn(*args)      # out["pcm"]: f32[2048]
"""

from __future__ import annotations


def entry(device=None):
    """Return ``(fn, (carry, frame, params))``: one 1080p video frame
    through the full pipeline (vision features -> spectral synthesis ->
    irfft/AGC/OLA), :func:`vaudio_torch.runtime.step.frame_step` with the
    synthesis constants and the window built once, on ``device`` (the card
    unless ``"cpu"`` is asked for).  The arguments are
    :meth:`AuralizerModel.example_inputs`: the initial carry, a black f32
    frame on the device and the default live params as host values."""
    import torch

    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.dsp.core import hann_window_norm
    from vaudio_torch.models import AuralizerModel
    from vaudio_torch.runtime.step import frame_step, params_to_device
    from vaudio_torch.synth.spectrum import SynthConstants

    model = AuralizerModel(AuralizerConfig(), device=device)
    carry, frame, params = model.example_inputs(height=1080, width=1920)
    cfg, dev = model.config, model.device
    consts = SynthConstants.create(cfg, dev)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=dev)

    def fn(carry, frame, params):
        return frame_step(carry, frame, params_to_device(params, cfg, dev),
                          cfg, consts, window)

    return fn, (carry, frame, params)
