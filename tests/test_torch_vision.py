"""vaudio_torch.vision.features against vaudio.vision.features on the same
numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_frames import structured_frames
from vaudio_torch.config import AuralizerConfig
from vaudio.vision import features as jf
from vaudio_torch.vision import features as tf

CFG = AuralizerConfig()


def t(x):
    return torch.as_tensor(np.array(x))


def test_acos_poly(rng):
    """XLA:CPU's sqrt is not correctly rounded; PyTorch's is: 3e-7 abs."""
    x = np.concatenate([rng.uniform(-1, 1, 50000),
                        [-1.0, -0.5, 0.0, 0.5, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(tf.acos_poly(t(x)).numpy(),
                               np.asarray(jf.acos_poly(x)), atol=3e-7)


@pytest.mark.parametrize("fast_acos", [True, False])
def test_rgb_to_hsi_planes(rng, fast_acos):
    """S and I bit-exact; H within 1e-5 (the sqrt and acos ulps, amplified
    near grey where the denominator vanishes); grey pixels give H = 0."""
    rgb = rng.uniform(0, 1, (3, 60, 80)).astype(np.float32)
    rgb[:, :5, :5] = 0.5
    ref = jf.rgb_to_hsi_planes(*rgb, fast_acos)
    got = tf.rgb_to_hsi_planes(*t(rgb), fast_acos=fast_acos)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[0][:5, :5].any()


@pytest.mark.parametrize("shape,level", [((64, 64), 3), ((61, 47), 3),
                                         ((33, 64), 2), ((17, 9), 1)])
def test_mip_u8_path(rng, shape, level):
    """Integer block sums exact (scale 4^l makes the epilogue the identity
    plus 128 * 4^l); the 1/255 output within 1 ulp of the scaled sum
    (<= 0.5, so 6e-8; config.py:116-119); ragged rows and columns
    dropped."""
    planes = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    for scale, atol in [(float(4 ** level), 0), (1 / 255.0, 6e-8)]:
        ref = np.asarray(jf.mip_downsample_planes(jnp.asarray(planes), level,
                                                  scale=scale))
        got = tf.mip_downsample_planes(t(planes), level, scale=scale).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_mip_f32_path(rng):
    """Banded f32 matmuls in both: 1e-6 abs on [0, 1] planes."""
    planes = rng.uniform(0, 1, (2, 3, 40, 56)).astype(np.float32)
    got = tf.mip_downsample_planes(t(planes), 3).numpy()
    for k in range(2):
        ref = np.asarray(jf.mip_downsample_planes(jnp.asarray(planes[k]), 3))
        np.testing.assert_allclose(got[k], ref, atol=1e-6)


def test_stencils_are_exact(rng):
    """Weights 1, -1 and 4 are exact products: equal bits, edges
    clamped."""
    plane = rng.uniform(0, 1, (2, 23, 31)).astype(np.float32)
    got = tf.feature_stencil_plane(t(plane)).numpy()
    for k in range(2):
        np.testing.assert_array_equal(
            got[k], np.asarray(jf.feature_stencil_plane(plane[k])))


def test_kernel_order_stencils_match_the_masks(rng):
    """intensity_stencils (the vision kernel's sums, K3's plain version)
    against the mask form: the same values up to the order of the sums,
    within 1e-6 on [0, 1] planes; edges clamped alike."""
    plane = t(rng.uniform(0, 1, (2, 23, 32)).astype(np.float32))
    np.testing.assert_allclose(tf.intensity_stencils(plane).numpy(),
                               tf.feature_stencil_plane(plane).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("hm,wm", [(24, 32), (135, 240), (33, 47)])
def test_cell_tiles_and_bin_factorization(hm, wm):
    assert tf._cell_tile_bounds(hm, wm, 4) == jf._cell_tile_bounds(hm, wm, 4)
    for bins in (360, 97, 64):
        assert tf.hue_bin_factorization(bins) == \
            jf.hue_bin_factorization(bins)


@pytest.mark.parametrize("hm,wm", [(24, 32), (24, 24), (27, 43)])
def test_histogram_counts_equal_tiled_method(rng, hm, wm):
    """Integer counts from the scatter-add equal the JAX tiled method's on
    the same HSI planes, gate included; batched over frames."""
    h = rng.uniform(0, 1, (2, hm, wm)).astype(np.float32)
    s = rng.choice([0.0, 0.5], (2, hm, wm)).astype(np.float32)
    i = rng.uniform(0, 0.3, (2, hm, wm)).astype(np.float32)
    got = tf.hue_histogram_planes(t(h), t(s), t(i), CFG).numpy()
    for k in range(2):
        ref = np.asarray(jf.hue_histogram_planes(h[k], s[k], i[k], CFG,
                                                 method="tiled"))
        np.testing.assert_array_equal(got[k], ref)


def test_hist_argmax_takes_the_last_maximum(rng):
    hist = rng.integers(0, 4, (3, 16, 360)).astype(np.float32)
    mx, arg = tf.hist_max_and_arg(t(hist))
    mx_ref, arg_ref = jf.hist_max_and_arg(hist)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mx_ref))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(arg_ref))


@pytest.mark.parametrize("mixing", [0.9, 0.5, 0.97])
def test_hue_ema_exhaustive(mixing):
    """Every (prev hue, argmax bin) pair: equal to the JAX update run op
    by op, where f32 rounds after each multiply and add as in the port."""
    prev = np.repeat(np.arange(0, 361), 360).astype(np.int32)
    arg = np.tile(np.arange(360), 361).astype(np.float32)
    mx = np.where(prev % 7 == 0, 10, 30).astype(np.float32)   # gate 20
    m = np.float32(mixing)
    ref = np.asarray(jf.update_hues_from_stats(mx, arg, prev, m, CFG))
    got = tf.update_hues_from_stats(t(mx), t(arg), t(prev), t(m), CFG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hm,wm", [(24, 32), (24, 24), (20, 40)])
def test_gradient_stats(rng, hm, wm):
    """The linear-slice fast path (wm % 16 == 0) and the generic rotated
    path: 1e-6 (sum order)."""
    modes = rng.normal(0, 0.2, (2, 4, hm, wm)).astype(np.float32)
    got = tf.cell_gradient_stats_planes(t(modes), CFG).numpy()
    for k in range(2):
        ref = np.asarray(jf.cell_gradient_stats_planes(modes[k], CFG))
        np.testing.assert_allclose(got[k], ref, atol=1e-6)


@pytest.mark.parametrize("H,W", [(192, 256), (192, 192)])
def test_frame_stats_and_extract_features(H, W):
    """u8 structured frames end to end through the vision pass: counts and
    hues exact, grads within 1e-6."""
    frames = structured_frames(3, 2, H, W)
    hist, grads = tf.frame_stats(t(frames), CFG)
    prev = np.arange(16, dtype=np.int32) * 20
    for k in range(2):
        h_ref, g_ref, _ = jf.frame_stats(jnp.asarray(frames[k]), CFG)
        np.testing.assert_array_equal(hist[k].numpy(), np.asarray(h_ref))
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g_ref),
                                   atol=1e-6)
        hues, g1 = tf.extract_features(t(frames[k]), t(prev),
                                       t(np.float32(0.9)), CFG)
        hues_ref, _, _ = jf.extract_features(jnp.asarray(frames[k]), prev,
                                             np.float32(0.9), CFG)
        np.testing.assert_array_equal(hues.numpy(), np.asarray(hues_ref))
        assert (hues.numpy() != prev).any()
