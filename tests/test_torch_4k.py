"""The 4K configuration (2160x3840, mip 3 = 270x480 mips), the JAX
package's second published one, on the CPU: K3's gate in both packages,
the vision stages the 4K paths run (the gate refuses the kernel there) on
a 4K-sized mip against the JAX package's XLA stages, the main path end to
end on frames whose mips are 4K-sized, K1's plain version at the 4K width,
and the bench's static floor at 4K.  The frames stay small: 540x960 at
mip 1 gives the mips of 4K at mip 3.  The card's 4K runs are
tests/test_torch_cuda.py's and chip_smoke.py's (phase_4k)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vaudio.runtime.chunked as jax_chunked
from torch_frames import _COLORS, structured_frames
from vaudio.ops import vision_kernel as jax_vision_kernel
from vaudio.vision import features as jf
from vaudio_torch import bench
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.ops import pool_kernel, vision_kernel
from vaudio_torch.runtime import chunked
from vaudio_torch.vision import features as tf

CFG = AuralizerConfig()
UHD_MIP = (270, 480)
# tests/test_torch_vision.py's bands: H within 1e-5 (sqrt and acos ulps),
# the cells' statistics within 1e-6 (sum order); tests/test_torch_pipeline.py's
# PCM band.
HUE_ATOL, GRADS_ATOL, PCM_ATOL = 1e-5, 1e-6, 2e-5


# hm * wm * 4 * 26 <= 10 MB: at wm = 320 the bound falls between hm = 315
# (10,483,200 bytes) and 316 (10,516,480).
@pytest.mark.parametrize("hm,wm", [
    (135, 240), (180, 320), (270, 480), (315, 320), (316, 320),
    (270, 481), (1, 480), (2, 16), (4320, 16), (540, 960),
])
def test_vision_gate_agrees_with_jax(hm, wm):
    """``supports`` is the JAX package's gate on every shape, the 10 MB
    bound included (the 4K mip is refused, 1080p and 1440p are taken);
    ``kernel_takes`` drops only the bound."""
    got = vision_kernel.supports(hm, wm, CFG)
    assert got == jax_vision_kernel.supports(hm, wm, CFG)
    takes = vision_kernel.kernel_takes(hm, wm, CFG)
    assert takes == (wm % CFG.num_cells == 0 and min(hm, wm) >= 2)
    assert got == (takes and hm * wm * 4 * 26 <= 10 << 20)


def uhd_mip(seed: int) -> np.ndarray:
    """A seeded f32 mip (3, 270, 480): each pixel one of
    tests/torch_frames.py's saturated colours whose hue lies mid-bin (no
    f32 evaluation order moves it across a bin edge), a dark band that
    fails the intensity gate and a grey band (S = 0)."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(len(_COLORS), size=UHD_MIP)
    mip = (_COLORS[pick].astype(np.float32) / np.float32(255.0)).transpose(
        2, 0, 1).copy()
    mip[:, :16] = 0.05
    mip[:, 16:32] = 0.7
    return mip


@pytest.mark.parametrize("fast_acos", [True, False])
def test_vision_stages_at_the_4k_mip_match_jax(fast_acos):
    """The unfused stages the 4K paths run, on one 4K-sized mip, against
    the JAX package's XLA stages on the same planes: S and I and the
    stencils bit for bit, H within 1e-5, the histogram exact, the cells'
    statistics within 1e-6."""
    mip = uhd_mip(0)
    h, s, i = tf.rgb_to_hsi_planes(*torch.as_tensor(mip),
                                   fast_acos=fast_acos)
    jh, js, ji = jf.rgb_to_hsi_planes(*mip, fast_acos)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HUE_ATOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hist = tf.hue_histogram_planes(h, s, i, CFG).numpy()
    np.testing.assert_array_equal(hist, np.asarray(jf.hue_histogram_planes(
        jh, js, ji, CFG, method="tiled")))
    assert 0 < hist.sum() < UHD_MIP[0] * UHD_MIP[1]   # the gate dropped some
    modes = tf.feature_stencil_plane(i)
    jmodes = jf.feature_stencil_plane(ji)
    np.testing.assert_array_equal(modes.numpy(), np.asarray(jmodes))
    np.testing.assert_allclose(
        tf.cell_gradient_stats_planes(modes, CFG).numpy(),
        np.asarray(jf.cell_gradient_stats_planes(jmodes, CFG)),
        atol=GRADS_ATOL)


def test_frame_stats_at_the_4k_mip_take_the_unfused_stages():
    """With use_pallas_vision the 4K-sized mip is refused by the gate, so
    frame_stats runs the unfused stages and never K3's entry: equal to
    the same config without the flag."""
    cfg = AuralizerConfig(use_pallas_vision=True, mip_level=1)
    frames = torch.as_tensor(structured_frames(3, 2, 540, 960, mip=1))
    calls = []
    real = vision_kernel.vision_stats
    vision_kernel.vision_stats = lambda *a: calls.append(1) or real(*a)
    try:
        got = tf.frame_stats(frames, cfg)
    finally:
        vision_kernel.vision_stats = real
    ref = tf.frame_stats(frames, AuralizerConfig(mip_level=1))
    assert not calls
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("channels", [1, 2])
def test_main_path_with_4k_mips_matches_jax(monkeypatch, channels):
    """540x960 frames at mip 1 have 4K's 270x480 mips: 4 frames with
    use_pallas_vision through run_offline_batched in both packages, the
    JAX package with its tests' CPU interpret escape (its pool kernel in
    interpret mode; its vision gate refuses the mip as the port's does):
    hues equal, grads within 1e-6, PCM within 2e-5."""
    monkeypatch.setattr(jf, "_PALLAS_POOL_ON_CPU", True)
    cfg = AuralizerConfig(channels=channels, mip_level=1,
                          use_pallas_vision=True)
    frames = structured_frames(11, 4, 540, 960, mip=1)
    params = LiveParams().as_arrays()
    a_ref, _, d_ref = jax_chunked.run_offline_batched(
        frames, cfg, dict(params), chunk=4, debug=True)
    a_got, _, d_got = chunked.run_offline_batched(
        frames, cfg, dict(params), chunk=4, debug=True, device="cpu")
    hues = d_got["hues"].numpy()
    np.testing.assert_array_equal(hues, np.asarray(d_ref["hues"]))
    assert len(np.unique(hues)) > 10               # the hues really moved
    np.testing.assert_allclose(d_got["grads"].numpy(),
                               np.asarray(d_ref["grads"]), atol=GRADS_ATOL)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert np.abs(np.asarray(a_ref)).max() > 0


@pytest.mark.parametrize("scale", [64.0, 1 / 255.0])
def test_k1_plain_at_the_4k_width_equals_jax(scale):
    """K1's plain version on u8 planes (3, 64, 3840) at mip 3, the 4K
    width (480 texels a row), equal bit for bit to the JAX package's
    mip_downsample_planes (the integer sums at scale 4^3, the mips at
    1/255)."""
    planes = np.random.default_rng(1).integers(0, 256, (3, 64, 3840),
                                               dtype=np.uint8)
    got = pool_kernel.mip_pool_plain(torch.as_tensor(planes), 3, scale)
    ref = np.asarray(jf.mip_downsample_planes(jnp.asarray(planes), 3,
                                              scale=scale))
    assert got.shape == (3, 8, 480)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


def test_bench_static_floor_at_4k():
    """The bench's floor at 2160x3840 stereo: 7.428 us of u8 frame read at
    3.35 TB/s and 0.530 us of K2's operations at 67 TFLOP/s (the same as
    at 1080p: the contraction does not depend on the frame size)."""
    frame_us, spectrum_us = bench.static_floor_us(2160, 3840,
                                                  bench.bench_config(2))
    assert frame_us == pytest.approx(7.428, abs=1e-3)
    assert spectrum_us == pytest.approx(0.530, abs=1e-3)
    assert round(frame_us + spectrum_us, 2) == 7.96
