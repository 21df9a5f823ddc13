"""The plain PyTorch versions of kernels K1 and K2 against the TPU kernels
they replace (Pallas in interpret mode, as tests/test_pallas.py runs them),
and the wrappers' device routing.  The CUDA kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaudio.config import AuralizerConfig
from vaudio.ops.pool_kernel import mip_pool_pallas
from vaudio.ops.spectrum_kernel import hann_peak_weighted_sum_batched
from vaudio.runtime.chunked import _batched_contraction
from vaudio.synth import SynthConstants as JaxConsts
from vaudio_torch.ops import _build, pool_kernel, spectrum_kernel

CFG = AuralizerConfig()


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("shape,level", [((64, 64), 3), ((64, 48), 1),
                                         ((61, 45), 2), ((37, 64), 3)])
def test_k1_plain_matches_pallas_kernel(rng, shape, level):
    """Integer block sums exact; the 1/255 output within 1 ulp of the
    scaled sum (<= 0.5, so 6e-8; config.py:116-119: the JAX multiply-add
    may be one FMA); ragged rows and columns dropped."""
    planes = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    frames = np.ascontiguousarray(planes.transpose(1, 2, 0))[None]
    for scale, atol in [(float(4 ** level), 0), (1 / 255.0, 6e-8)]:
        ref = np.asarray(mip_pool_pallas(jnp.asarray(planes), level,
                                         scale=scale, interpret=True))
        got = pool_kernel.mip_pool(t(frames), level, scale=scale)[0].numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def k2_inputs(rng, T, K, special=False):
    NP = 496
    pf = rng.uniform(20, 20000, (T, NP)).astype(np.float32)
    scale = (rng.choice([1.0, 0.2], (T, NP)) / CFG.bin_width
             ).astype(np.float32)
    if special:
        # Bin distances d in {0, +-1, +-0.5, +-2.5}: partials placed at
        # freqs[f] - d / scale for a few bins f.
        freqs = CFG.bin_frequencies()
        ds = np.array([0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5], np.float32)
        scale[:, :7] = np.float32(1.0)
        pf[:, :7] = freqs[100:107] - ds
    w = rng.normal(0, 0.1, (T, NP, K)).astype(np.float32)
    return pf, scale, w


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("special", [False, True])
def test_k2_plain_matches_pallas_kernel(rng, K, special):
    """T=2 at the real F=2047, NP=496: 1e-5, the contraction band
    (vaudio/runtime/chunked.py:23-25)."""
    pf, scale, w = k2_inputs(rng, 2, K, special)
    freqs = CFG.bin_frequencies()
    ref = np.asarray(hann_peak_weighted_sum_batched(
        jnp.asarray(freqs), jnp.asarray(pf), jnp.asarray(scale),
        jnp.asarray(w), num_bins=CFG.num_bins, interpret=True))
    got = spectrum_kernel.hann_peak_weighted_sum(t(freqs), t(pf), t(scale),
                                                 t(w)).numpy()
    assert got.shape == (2, CFG.num_bins, K)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("K", [2, 4])
def test_k2_plain_matches_xla_contraction(rng, K):
    """Against the JAX pipeline's default (XLA) batched contraction, on the
    partials' inverse bandwidths: 1e-5."""
    pf, _, w = k2_inputs(rng, 2, K)
    ibw = rng.choice([1.0, 0.2], pf.shape).astype(np.float32)
    ref = np.asarray(_batched_contraction(
        jnp.asarray(pf), jnp.asarray(w), jnp.asarray(ibw), CFG,
        JaxConsts.create(CFG), use_pallas=False))
    scale = t(ibw) * float(np.float32(1.0 / CFG.bin_width))
    got = spectrum_kernel.hann_peak_weighted_sum(
        t(CFG.bin_frequencies()), t(pf), scale, t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_counting(rng):
    frames = t(rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
    pf, scale, w = k2_inputs(rng, 1, 2)
    before = (pool_kernel.launches, spectrum_kernel.launches)
    pool_kernel.mip_pool(frames, 3, 1 / 255.0)
    spectrum_kernel.hann_peak_weighted_sum(t(CFG.bin_frequencies()), t(pf),
                                           t(scale), t(w))
    assert (pool_kernel.launches, spectrum_kernel.launches) == before


def test_wrappers_raise_for_a_device_without_kernel():
    """No fallback: a tensor that is neither on the CPU nor on CUDA raises
    (the meta device stands in for any other)."""
    meta = torch.empty((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pool_kernel.mip_pool(meta, 3)
    f = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spectrum_kernel.hann_peak_weighted_sum(
            f, torch.empty((1, 4), device="meta"),
            torch.empty((1, 4), device="meta"),
            torch.empty((1, 4, 2), device="meta"))


def test_build_is_keyed_by_the_sources():
    """The library path is under build/vaudio_torch/<hash of the CUDA
    sources and flags>/; nothing is compiled to compute it."""
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert {p.name for p in _build._sources()} >= {"pool_kernel.cu",
                                                   "spectrum_kernel.cu"}
    assert path == _build.library_path()
