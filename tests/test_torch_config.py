"""The port's own configuration (vaudio_torch/config.py) held to the JAX
package's field for field, and the device rule of the port's entry points:
the card unless the caller asks for the CPU, never a quiet fall-back."""

import dataclasses

import numpy as np
import pytest
import torch

import vaudio.config as jax_config
import vaudio_torch
from vaudio_torch import config as port_config
from vaudio_torch.api import Auralizer
from vaudio_torch.runtime import chunked, step
from vaudio_torch.synth import spectrum

CONFIGS = [
    {},
    dict(sample_rate=48000.0, channels=2),
    dict(nfft=2048, grid_size=3, num_hue_bins=180, quirk_compat=False),
    dict(num_harmonics=9, sample_rate=22050.0, video_fps=60.0),
]


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["AuralizerConfig", "LiveParams"])
def test_fields_defaults_and_types_match(name):
    port, ref = getattr(port_config, name), getattr(jax_config, name)
    assert _fields(port) == _fields(ref)
    assert port.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


def test_constants_match():
    assert port_config.BESSEL_RATIOS == jax_config.BESSEL_RATIOS
    assert dataclasses.asdict(port_config.DEFAULT_CONFIG) == \
        dataclasses.asdict(jax_config.DEFAULT_CONFIG)


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_derived_properties_match(kwargs):
    port = port_config.AuralizerConfig(**kwargs)
    ref = jax_config.AuralizerConfig(**kwargs)
    for prop in ("num_cells", "n", "num_bins", "hop_size", "bin_width",
                 "num_bessel", "phase_stride", "phase_read_stride",
                 "num_phase_slots"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.bin_frequencies().tobytes() == ref.bin_frequencies().tobytes()
    assert port.bessel_ratios().tobytes() == ref.bessel_ratios().tobytes()


@pytest.mark.parametrize("pan", [None, [0.1 * k for k in range(16)]])
def test_live_params_as_arrays_match(pan):
    kw = dict(attack=0.3, stereo_width=0.5, pan_angles=pan)
    got = port_config.LiveParams(**kw).as_arrays()
    ref = jax_config.LiveParams(**kw).as_arrays()
    assert got.keys() == ref.keys()
    for k in ref:
        assert type(got[k]) is type(ref[k]), k
        np.testing.assert_array_equal(got[k], ref[k])
    assert port_config.LiveParams().as_arrays().keys() == \
        jax_config.LiveParams().as_arrays().keys()


def test_the_jax_config_works_by_attribute():
    """The port reads a config by attribute only: the JAX package's gives
    the same PCM as the port's own."""
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    frames[:, :, :16] = (220, 60, 30)
    got, _, _ = step.run_offline(frames, port_config.AuralizerConfig(),
                                 device="cpu")
    ref, _, _ = step.run_offline(frames, jax_config.AuralizerConfig(),
                                 device="cpu")
    assert torch.equal(got, ref)


def test_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vaudio_torch.device(None)
    assert vaudio_torch.device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert vaudio_torch.device(None) == torch.device("cuda")


def test_entry_points_without_a_card_raise(monkeypatch):
    """No entry point falls back to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.AuralizerConfig()
    frames = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="is_available"):
        Auralizer(config=cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        step.run_offline(frames, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        chunked.run_offline_batched(frames, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        step.make_step(cfg)


BARE_CALLS = {
    "init_carry": lambda cfg: step.init_carry(cfg),
    "carry_from_numpy": lambda cfg: step.carry_from_numpy(
        step.carry_to_numpy(step.init_carry(cfg, "cpu"))),
    "SynthConstants.create": lambda cfg: spectrum.SynthConstants.create(cfg),
    "SynthConstants.from_numpy": lambda cfg: spectrum.SynthConstants
    .from_numpy(**spectrum.SynthConstants.create(cfg, "cpu").to_numpy()),
    "live_pan_gains": lambda cfg: spectrum.live_pan_gains(cfg, 0.5),
    "live_pan_from_params": lambda cfg: spectrum.live_pan_from_params(
        cfg, {"stereo_width": 0.5}),
}


@pytest.mark.parametrize("name", sorted(BARE_CALLS))
def test_the_frame_step_surface_without_a_card_raises(monkeypatch, name):
    """The pieces a caller of frame_step builds itself (the carry, the
    synthesis constants, the live pan) run on the card unless the CPU is
    asked for: called bare without a card they raise the port's error,
    never hand back CPU tensors."""
    cfg = port_config.AuralizerConfig(channels=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        BARE_CALLS[name](cfg)
