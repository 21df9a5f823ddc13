"""The port's library surface against the JAX package's: every public name
of ``vaudio`` and of its subpackages imports from its ``vaudio_torch``
counterpart, and the channels-last vision functions match the JAX ones on
the same numpy inputs."""

import importlib

import numpy as np
import pytest
import torch

from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.vision import features as jf
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.vision import features as tf

SUBPACKAGES = ["dsp", "synth", "vision", "runtime", "utils", "ops", "io",
               "models", "parallel"]

# The JAX package's TPU kernel names, which the port does not alias, and
# the port's entries that replace them (vaudio_torch/ops/__init__.py).
TPU_NAMES = {
    "mip_pool_pallas": "vaudio_torch.ops.mip_pool",
    "hann_peak_weighted_sum_batched":
        "vaudio_torch.ops.hann_peak_weighted_sum",
    "spectrum_pallas": "vaudio_torch.synth.spectrum.contract_spectrum",
    "vision_stats_pallas": "vaudio_torch.ops.vision_stats",
}


@pytest.mark.parametrize("sub", [None] + SUBPACKAGES)
def test_every_public_name_imports_from_the_port(sub):
    """Each name of the JAX module's ``__all__`` is in the port module's
    ``__all__`` and is a function or class there where it is one in the
    JAX package; a TPU kernel name is absent, and the port's docstring
    maps it to the entry that replaces it."""
    suffix = f".{sub}" if sub else ""
    ref = importlib.import_module("vaudio" + suffix)
    port = importlib.import_module("vaudio_torch" + suffix)
    for name in ref.__all__:
        if name in TPU_NAMES:
            assert not hasattr(port, name)
            mod, attr = TPU_NAMES[name].rsplit(".", 1)
            assert callable(getattr(importlib.import_module(mod), attr))
            line = next(ln for ln in port.__doc__.splitlines()
                        if f"``{name}``" in ln)
            assert f"{attr}`" in line, line
            continue
        assert name in port.__all__, f"{port.__name__} lacks {name}"
        assert callable(getattr(port, name)) == callable(getattr(ref, name))


def test_importing_the_subpackages_builds_no_kernel():
    """The kernels are built at their first launch, never at import."""
    for sub in SUBPACKAGES:
        importlib.import_module(f"vaudio_torch.{sub}")
    from vaudio_torch.ops import _build
    assert _build._lib is None


def test_rgb_to_hsi(rng):
    """S and I equal bit for bit; H within 1e-5 of a turn, the band of
    ``rgb_to_hsi_planes`` (XLA:CPU's sqrt is not correctly rounded and
    acos amplifies an ulp of its argument near +-1; measured 3.9e-7)."""
    rgb = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    rgb[:4, :4] = 0.5                                   # grey: H = 0
    got = tf.rgb_to_hsi(rgb).numpy()
    ref = np.asarray(jf.rgb_to_hsi(rgb))
    assert got.shape == ref.shape == (48, 64, 3)
    np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., 1:], ref[..., 1:])
    assert not got[:4, :4, 0].any()


@pytest.mark.parametrize("shape", [(96, 128), (61, 47)])
@pytest.mark.parametrize("quantize", [False, True])
def test_mip_downsample(rng, shape, quantize):
    """Within 1e-6 (the f32 path's two banded products sum in another
    order; measured 1.2e-7), and the 8-bit quantized chain equal bit for
    bit; ragged rows and columns dropped."""
    frame = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    got = tf.mip_downsample(frame, 3, quantize).numpy()
    ref = np.asarray(jf.mip_downsample(frame, 3, quantize))
    assert got.shape == ref.shape == (shape[0] >> 3, shape[1] >> 3, 3)
    if quantize:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_feature_stencil(rng):
    """The four masks on each HSI channel, edges clamped: equal bits."""
    hsi = rng.uniform(0, 1, (23, 31, 3)).astype(np.float32)
    got = tf.feature_stencil(hsi).numpy()
    ref = np.asarray(jf.feature_stencil(hsi))
    assert got.shape == (23, 31, 3, 4)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["tiled", "matmul", "scatter"])
def test_hue_histogram(rng, method):
    """Every method's counts equal the JAX package's, on a rotated HSI
    image with grey and dark pixels gated out."""
    rgb = rng.uniform(0, 1, (40, 64, 3)).astype(np.float32)
    rgb[:6] = 0.05                                      # I below the gate
    hsi_rot = np.array(jf.rotate_cw(jf.rgb_to_hsi(rgb)))
    got = tf.hue_histogram(hsi_rot, AuralizerConfig(), method).numpy()
    ref = np.asarray(jf.hue_histogram(hsi_rot, JaxConfig(), method))
    assert got.shape == (16, 360)
    assert 0 < got.sum() < 40 * 64
    np.testing.assert_array_equal(got, ref)


def test_hue_histogram_unknown_method():
    hsi_rot = np.zeros((16, 8, 3), np.float32)
    for fn, cfg in ((tf.hue_histogram, AuralizerConfig()),
                    (jf.hue_histogram, JaxConfig())):
        with pytest.raises(ValueError, match="unknown histogram method"):
            fn(hsi_rot, cfg, "bogus")


@pytest.mark.parametrize("width", [64, 60])
@pytest.mark.parametrize("linear", [True, False])
def test_cell_gradient_stats(rng, width, linear):
    """Rotated (Wm, Hm, 4) mode maps: the linear-slice cells (column bands
    where Wm % 16 == 0, else the explicit rotation) and the spatial cells,
    within 2e-5 (sums in another order)."""
    feat_rot = rng.normal(0, 1, (width, 40, 4)).astype(np.float32)
    got = tf.cell_gradient_stats(
        feat_rot, AuralizerConfig(linear_cell_grads=linear)).numpy()
    ref = np.asarray(jf.cell_gradient_stats(
        feat_rot, JaxConfig(linear_cell_grads=linear)))
    assert got.shape == (16, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


GATE_CASES = [(135, 240, {}), (135, 240, {"use_pallas_vision": False}),
              (270, 480, {}), (135, 240, {"linear_cell_grads": False}),
              (40, 60, {}), (1, 32, {})]


@pytest.mark.parametrize("hm,wm,kw", GATE_CASES)
def test_use_vision_kernel(monkeypatch, hm, wm, kw):
    """The port's gate is the flag and the kernel's shape gate on any
    device; the JAX package's equals it where it may run its kernel (its
    tests' CPU interpret mode) and is False on a plain CPU backend."""
    kw = {"use_pallas_vision": True, **kw}
    cfg, jcfg = AuralizerConfig(**kw), JaxConfig(**kw)
    got = tf.use_vision_kernel(hm, wm, cfg)
    assert jf.use_vision_kernel(hm, wm, jcfg) is False
    monkeypatch.setattr(jf, "_PALLAS_POOL_ON_CPU", True)
    assert got == jf.use_vision_kernel(hm, wm, jcfg)
    supported = (hm, wm, kw) == (135, 240, {"use_pallas_vision": True})
    assert got is supported


def test_frame_stats_takes_the_gate(monkeypatch):
    """frame_stats runs K3's entry exactly where use_vision_kernel says."""
    from vaudio_torch.ops import vision_kernel
    calls = []
    real = vision_kernel.vision_stats
    monkeypatch.setattr(vision_kernel, "vision_stats",
                        lambda *a: calls.append(1) or real(*a))
    frames = torch.as_tensor(np.random.default_rng(1).integers(
        0, 256, (2, 64, 128, 3), dtype=np.uint8))
    for flag, want in ((True, 1), (False, 0)):
        calls.clear()
        hist, grads = tf.frame_stats(
            frames, AuralizerConfig(use_pallas_vision=flag))
        assert len(calls) == want
        assert hist.shape == (2, 16, 360) and grads.shape == (2, 16, 4)
