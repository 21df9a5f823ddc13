"""vaudio_torch.dsp.core against vaudio.dsp.core on the same numpy inputs.

JAX is called eagerly (op by op), where XLA cannot contract a multiply and
an add into an FMA: the port's element functions then agree bit for bit.
Transcendentals (sin, exp, exp2) differ by an ulp between XLA:CPU and
PyTorch and are held to a few ulps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaudio_torch.config import AuralizerConfig
from vaudio.dsp import core as jd
from vaudio_torch.dsp import core as td

CFG = AuralizerConfig()


def t(x):
    return torch.as_tensor(np.asarray(x))


def test_hann_window_norm_is_byte_equal():
    assert td.hann_window_norm(4096).tobytes() == \
        jd.hann_window_norm(4096).tobytes()


@pytest.mark.parametrize("fn", ["sinpi_reduced", "hann_sinc_peak_fast"])
def test_polynomial_peak_is_bit_exact(rng, fn):
    """Same op order, no transcendental: equal bits."""
    d = rng.uniform(-60, 60, 100000).astype(np.float32)
    if fn == "sinpi_reduced":
        d = (d / 120.0).astype(np.float32)
    ref = np.asarray(getattr(jd, fn)(jnp.asarray(d)))
    got = getattr(td, fn)(t(d)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_peak_special_points():
    """The exact limits at 0 and +-1, half-to-even rounding at +-0.5 and
    +-2.5: equal bits, and the limits exact."""
    d = np.array([0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, 2.0, -2.0,
                  1e-7, 1 + 1e-7], np.float32)
    got = td.hann_sinc_peak_fast(t(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd.hann_sinc_peak_fast(d)))
    np.testing.assert_array_equal(got[:3], [0.5, -0.25, -0.25])


def test_three_sinc_peak(rng):
    """jnp.sin vs torch.sin: 1e-7 abs (a few ulps of values <= 0.5)."""
    d = rng.uniform(-50, 50, 20000).astype(np.float32)
    np.testing.assert_allclose(td.hann_sinc_peak(t(d)).numpy(),
                               np.asarray(jd.hann_sinc_peak(d)), atol=1e-7)


def test_hue_to_f0_snaps_to_the_same_bin_for_every_hue():
    """exp2 differs by <= 1 ulp; the snapped bin is equal for all 361
    hues, so f0 on the grid is exact."""
    hues = np.arange(0, 361, dtype=np.int32)
    ref = np.asarray(jd.hue_to_f0(hues))
    got = td.hue_to_f0(t(hues)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2.4e-7)
    freqs = CFG.bin_frequencies()
    np.testing.assert_array_equal(
        td.find_closest_index(t(freqs), t(got)).numpy(),
        np.asarray(jd.find_closest_index(freqs, ref)))


def test_find_closest_index_ties_and_clamps(rng):
    """Exact: the low index on an exact midpoint, 0 below the grid, n-1
    above it."""
    freqs = np.arange(0, 100, 10, dtype=np.float32)
    targets = np.concatenate([
        rng.uniform(-20, 120, 500),
        [-5.0, 0.0, 5.0, 15.0, 45.0, 90.0, 95.0, 1e6]]).astype(np.float32)
    got = td.find_closest_index(t(freqs), t(targets)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jd.find_closest_index(freqs, targets)))
    assert got[-6] == 0 and got[-5] == 1 and got[-1] == 9


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_irfft_from_half(rng, lead):
    """pocketfft in both: 1e-6 abs on unit-scale spectra; any leading
    dims (mono frames, stereo channels, chunk)."""
    spec = rng.normal(size=lead + (2047, 2)).astype(np.float32)
    got = td.irfft_from_half(t(spec)).numpy()
    flat = spec.reshape(-1, 2047, 2)
    ref = np.stack([np.asarray(jd.irfft_from_half(s[:, 0], s[:, 1]))
                    for s in flat]).reshape(lead + (4096,))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sigmoid_normalize(rng):
    x = rng.uniform(0, 3, 1000).astype(np.float32)
    m = rng.uniform(0.1, 3, 1000).astype(np.float32)
    np.testing.assert_allclose(td.sigmoid_normalize(t(x), t(m)).numpy(),
                               np.asarray(jd.sigmoid_normalize(x, m)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rmax,att,rel", [(1.0, 1.0, 1.0), (0.3, 0.5, 0.2),
                                          (2.0, 0.0, 1.0)])
@pytest.mark.parametrize("channels", [1, 2])
def test_agc_then_overlap_add(rng, rmax, att, rel, channels):
    """exp in the sigmoid: 1e-6 abs on unit-peak frames."""
    shape = (4096,) if channels == 1 else (channels, 4096)
    sig = rng.normal(size=shape).astype(np.float32)
    tail = rng.normal(size=shape).astype(np.float32)
    w = td.hann_window_norm(4096)
    f32 = np.float32
    n_ref, m_ref = jd.agc_normalize(sig, f32(rmax), f32(att), f32(rel))
    pcm_ref, tail_ref = jd.overlap_add(n_ref, tail, w)
    n_got, m_got = td.agc_normalize(t(sig), t(f32(rmax)), t(f32(att)),
                                    t(f32(rel)))
    pcm_got, tail_got = td.overlap_add(n_got, t(tail), t(w))
    np.testing.assert_allclose(float(m_got), float(m_ref), rtol=1e-6)
    np.testing.assert_allclose(pcm_got.numpy(), np.asarray(pcm_ref),
                               atol=1e-6)
    np.testing.assert_allclose(tail_got.numpy(), np.asarray(tail_ref),
                               atol=1e-6)
