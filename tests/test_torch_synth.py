"""vaudio_torch.synth.spectrum against vaudio.synth.spectrum on the same
numpy inputs (JAX eager, op by op)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio.synth import spectrum as js
from vaudio_torch.synth import spectrum as ts


def t(x):
    return torch.as_tensor(np.array(x))


def consts_pair(cfg):
    return js.SynthConstants.create(cfg), ts.SynthConstants.create(cfg, "cpu")


def frame_inputs(rng, cfg):
    hues = rng.integers(-5, 366, cfg.num_cells).astype(np.int32)
    grads = np.abs(rng.normal(0, 0.3, (cfg.num_cells, 4))).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (cfg.num_cells, cfg.phase_stride)
                         ).astype(np.float32)
    return hues, grads, phases


@pytest.mark.parametrize("cfg", [AuralizerConfig(),
                                 AuralizerConfig(quirk_compat=False),
                                 AuralizerConfig(sample_rate=48000.0,
                                                 channels=2)])
def test_synth_constants_are_byte_equal(cfg):
    ref, got = consts_pair(cfg)
    got = got.to_numpy()
    for f in dataclasses.fields(ref):
        a = getattr(ref, f.name)
        assert got[f.name].dtype == a.dtype, f.name
        assert got[f.name].tobytes() == a.tobytes(), f.name


def test_constants_from_numpy_round_trip():
    ref, _ = consts_pair(AuralizerConfig())
    got = ts.SynthConstants.from_numpy("cpu",
                                       **dataclasses.asdict(ref))
    for name, arr in got.to_numpy().items():
        assert arr.tobytes() == getattr(ref, name).tobytes(), name
    assert got.num_partials == ref.num_partials


def test_phase_advance_and_accumulate_are_bit_exact(rng):
    """The advance snaps f0 to the bin grid (exact); the accumulation is
    the FMA XLA:CPU compiles the JAX expression to (see phase_accumulate),
    so equal bits against the jitted reference."""
    import jax
    cfg = AuralizerConfig()
    cj, ct = consts_pair(cfg)
    hues = rng.integers(0, 360, (5, 16)).astype(np.int32)
    phases = rng.uniform(0, 2 * np.pi, (16, 32)).astype(np.float32)
    adv = ts.phase_advance(t(hues), cfg, ct).numpy()
    for k in range(5):
        np.testing.assert_array_equal(
            adv[k], np.asarray(js.phase_advance(jnp.asarray(hues[k]), cfg,
                                                cj)))
    acc = jax.jit(lambda p, h: js.phase_accumulate(p, h, cfg, cj))
    ref, got = phases, t(phases)
    for k in range(5):
        ref = acc(ref, hues[k])
        got = ts.phase_accumulate(got, t(hues[k]), cfg, ct)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quirk", [True, False])
def test_partial_weights(rng, quirk):
    """Exact frequencies; weights through pow/cos/sin within 1e-7 (a few
    ulps of weights <= 1/16); the stride-22 read quirk and invalid hues
    (< 0, > 360) included."""
    cfg = AuralizerConfig(quirk_compat=quirk)
    cj, ct = consts_pair(cfg)
    hues, grads, phases = frame_inputs(rng, cfg)
    ref = js.partial_weights(hues, grads, phases, cfg, cj)
    got = ts.partial_weights(t(hues), t(grads), t(phases), cfg, ct)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(got[1:3], ref[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def test_partial_weights_batched_equals_per_frame(rng):
    cfg = AuralizerConfig()
    _, ct = consts_pair(cfg)
    ins = [frame_inputs(rng, cfg) for _ in range(3)]
    batched = ts.partial_weights(*(t(np.stack(x)) for x in zip(*ins)),
                                 cfg, ct)
    for k, one in enumerate(ins):
        single = ts.partial_weights(*(t(x) for x in one), cfg, ct)
        for a, b in zip(batched, single):
            np.testing.assert_array_equal(a[k].numpy(), b.numpy())


def test_pan_gains(rng):
    cfg = AuralizerConfig(channels=2)
    np.testing.assert_array_equal(ts.cell_pan_gains(cfg),
                                  js.cell_pan_gains(cfg))
    angles = rng.uniform(0, np.pi / 2, 16).astype(np.float32)
    for width, ang in [(1.0, None), (0.3, None), (1.7, angles)]:
        ref = js.live_pan_gains(cfg, np.float32(width), angles=ang)
        got = ts.live_pan_gains(cfg, np.float32(width), angles=ang,
                                device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)


def test_spectral_filter_gain():
    freqs = AuralizerConfig().bin_frequencies()
    f32 = np.float32
    for hp, lp, ho, lo in [(500.0, 5000.0, 2.0, 1.0), (200.0, 18000.0,
                                                       0.0, 0.0)]:
        ref = js.spectral_filter_gain(jnp.asarray(freqs), f32(hp), f32(lp),
                                      f32(ho), f32(lo))
        got = ts.spectral_filter_gain(t(freqs), t(f32(hp)), t(f32(lp)),
                                      t(f32(ho)), t(f32(lo)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_flatten_partials_column_order(rng, channels):
    """Pure reshapes and one multiply: equal bits, stereo columns
    [L_re, L_im, R_re, R_im]."""
    cfg = AuralizerConfig(channels=channels)
    pf, wr, wi = (rng.normal(size=(16, 31)).astype(np.float32)
                  for _ in range(3))
    ibw = rng.uniform(0.2, 1, 16).astype(np.float32)
    ref = js.flatten_partials(pf, wr, wi, ibw, cfg)
    got = ts.flatten_partials(t(pf), t(wr), t(wi), t(ibw), cfg)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].shape == (496, 2 * channels)


@pytest.mark.parametrize("channels", [1, 2])
def test_contract_spectrum(rng, channels):
    """K2's CPU route against the JAX contraction: 1e-5, the contraction
    band (vaudio/runtime/chunked.py:23-25)."""
    cfg = AuralizerConfig(channels=channels)
    cj, ct = consts_pair(cfg)
    hues, grads, phases = frame_inputs(rng, cfg)
    flat = js.flatten_partials(*js.partial_weights(hues, grads, phases, cfg,
                                                   cj), cfg)
    ref = js.contract_spectrum(*flat, cfg, cj)
    got = ts.contract_spectrum(*(t(x) for x in flat), cfg, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("channels,filters", [(1, False), (2, False),
                                              (1, True)])
def test_build_spectrum(rng, channels, filters):
    """One frame's spectrum, rotated, filtered and smoothed: 1e-5."""
    cfg = AuralizerConfig(channels=channels, enable_filters=filters)
    cj, ct = consts_pair(cfg)
    hues, grads, phases = frame_inputs(rng, cfg)
    shape = (cfg.num_bins, 2) if channels == 1 else (2, cfg.num_bins, 2)
    prev = rng.normal(0, 0.01, shape).astype(np.float32)
    params = LiveParams(hp_cutoff=500.0, hp_order=2.0, lp_cutoff=5000.0,
                        lp_order=1.0).as_arrays()
    ref = js.build_spectrum(hues, grads, phases, prev, np.float32(0.5), cfg,
                            cj, filter_params=params)
    got = ts.build_spectrum(t(hues), t(grads), t(phases), t(prev),
                            t(np.float32(0.5)), cfg, ct,
                            filter_params={k: t(v) for k, v in
                                           params.items()})
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
