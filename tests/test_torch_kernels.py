"""The plain PyTorch versions of kernels K1-K4 against the TPU kernels
they replace (Pallas in interpret mode, as tests/test_pallas.py runs them),
K4's T-frame forms against their chained frames and its one-reduction
rule, and the wrappers' device routing.  The CUDA kernels themselves are
held to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import sigmoid_normalize
from vaudio.dsp import hann_window_norm
from vaudio.ops import vision_kernel as jax_vision_kernel
from vaudio.ops.audio_kernel import agc_overlap_add as jax_agc_overlap_add
from vaudio.ops.pool_kernel import mip_pool_pallas
from vaudio.ops.spectrum_kernel import hann_peak_weighted_sum_batched
from vaudio.runtime.chunked import _batched_contraction
from vaudio.synth import SynthConstants as JaxConsts
from torch_frames import (k4_args, k4_chained, k4_edge_frames, k4_forms,
                          k4_stream_args, k4_stream_forms)
from vaudio_torch.ops import (_build, audio_kernel, pool_kernel,
                              spectrum_kernel, vision_kernel)

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


def k3_mips(rng, shape, bands=False):
    """f32 mip planes (3, hm, wm) in [0, 1]; with ``bands`` a dark band
    (fails the intensity gate) and a grey band (S == 0, hue 0)."""
    mip = rng.uniform(0, 1, (3,) + shape).astype(np.float32)
    if bands:
        mip[:, :8, :] = 0.05
        mip[:, 8:16, :] = 0.7
    return mip


@pytest.mark.parametrize("shape,bands", [((16, 16), False),
                                         ((34, 48), False),
                                         ((32, 32), True)])
def test_k3_plain_matches_pallas_kernel(rng, shape, bands):
    """K3' (one frame) against the TPU kernel: histogram counts exact,
    gradient statistics within atol 1e-6, rtol 1e-5 (the band of
    tests/test_pallas.py:213-215; the sums are taken in another order)."""
    mip = k3_mips(rng, shape, bands)
    ref_h, ref_g = jax_vision_kernel.vision_stats_pallas(
        jnp.asarray(mip), CFG, interpret=True)
    got_h, got_g = vision_kernel.vision_stats(t(mip[None]), CFG)
    assert got_h.shape == (1, 16, 360) and got_g.shape == (1, 16, 4)
    np.testing.assert_array_equal(got_h[0].numpy(), np.asarray(ref_h))
    assert got_h.sum() > 0
    np.testing.assert_allclose(got_g[0].numpy(), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-6)


def test_k3_plain_matches_batched_pallas_kernel(rng):
    """K3 on a batch of 6 frames against the TPU kernel's frame-blocked
    form: counts exact, statistics within atol 1e-6, rtol 1e-5."""
    mips = np.stack([k3_mips(rng, (32, 32), bands=k % 2 == 1)
                     for k in range(6)])
    ref_h, ref_g = jax_vision_kernel.vision_stats_pallas_batched(
        jnp.asarray(mips), CFG, interpret=True)
    got_h, got_g = vision_kernel.vision_stats(t(mips), CFG)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("hm,wm,cfg", [
    (16, 17, CFG), (1, 16, CFG), (16, 1, CFG), (2, 16, CFG), (16, 16, CFG),
    (135, 240, CFG), (270, 480, CFG), (180, 320, CFG),
    (16, 16, dataclasses.replace(CFG, linear_cell_grads=False)),
    (16, 16, dataclasses.replace(CFG, num_hue_bins=359)),
])
def test_k3_supports_matches_jax(hm, wm, cfg):
    """The port's gate is the JAX package's (test_pallas.py:232-238 and the
    size bound: the 4K mip is refused, 1080p and 1440p are taken)."""
    assert vision_kernel.supports(hm, wm, cfg) == \
        jax_vision_kernel.supports(hm, wm, cfg)


TILE_SHAPES = [(135, 240), (61, 48), (34, 32), (2, 16), (180, 320)]
TILE_CASES = [(hm, wm, grid) for grid in (4, 2, 8) for hm, wm in TILE_SHAPES
              if wm % (grid * grid) == 0]


@pytest.mark.parametrize("hm,wm,grid", TILE_CASES)
def test_k3_tile_table_matches_the_tpu_kernel(hm, wm, grid):
    """The CUDA kernel's histogram blocks take the TPU kernel's own static
    tiles (vaudio/ops/vision_kernel.py::_kernel_setup), in cell order."""
    tiles = jax_vision_kernel._kernel_setup(hm, wm, grid, CFG.num_hue_bins,
                                            CFG.saturation_gate,
                                            CFG.intensity_gate)[0]
    rects = vision_kernel.block_rects(hm, wm, grid)
    assert rects.shape == (2 * grid * grid, 4) and rects.dtype == np.int32
    np.testing.assert_array_equal(rects[:grid * grid], np.array(tiles))


@pytest.mark.parametrize("hm,wm,grid", TILE_CASES)
def test_k3_tiles_cover_each_pixel_once(hm, wm, grid):
    """Every pixel lies in exactly one histogram tile, the tile of its cell
    by the per-pixel formula: row x grid / wm, column (hm-1-y) grid / hm."""
    count = np.zeros((hm, wm), np.int64)
    cell = np.full((hm, wm), -1, np.int64)
    for c, (y0, yh, x0, xw) in enumerate(
            vision_kernel.block_rects(hm, wm, grid)[:grid * grid]):
        count[y0:y0 + yh, x0:x0 + xw] += 1
        cell[y0:y0 + yh, x0:x0 + xw] = c
    y, x = np.meshgrid(np.arange(hm), np.arange(wm), indexing="ij")
    np.testing.assert_array_equal(count, 1)
    np.testing.assert_array_equal(
        cell, ((x * grid) // wm) * grid + ((hm - 1 - y) * grid) // hm)


@pytest.mark.parametrize("hm,wm,grid", TILE_CASES)
def test_k3_bands_cover_the_columns(hm, wm, grid):
    """The gradient blocks' bands: cell c spans all rows and columns
    c cw .. (c+1) cw - 1, cw = wm / cells, so together [0, wm) once."""
    cells = grid * grid
    bands = vision_kernel.block_rects(hm, wm, grid)[cells:]
    assert bands.shape == (cells, 4)
    np.testing.assert_array_equal(bands[:, :2], [[0, hm]] * cells)
    np.testing.assert_array_equal(bands[:, 3], wm // cells)
    cols = np.concatenate([np.arange(x0, x0 + xw) for _, _, x0, xw in bands])
    np.testing.assert_array_equal(cols, np.arange(wm))


K4_TRIPLES = [(1.0, 1.0, 1.0), (0.3, 0.5, 0.2), (2.0, 0.0, 1.0)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("case", range(len(K4_TRIPLES) + 1))
def test_k4_plain_matches_pallas_kernel(rng, channels, case):
    """K4 against the TPU kernel on the (running max, attack, release)
    triples of tests/test_pallas.py:111-112 and a zero signal: pcm and tail
    within 1e-6, the new running max within rtol 1e-6."""
    shape = (4096,) if channels == 1 else (channels, 4096)
    window = hann_window_norm(4096)
    if case == len(K4_TRIPLES):
        sig = np.zeros(shape, np.float32)
        tail = np.zeros(shape, np.float32)
        rmax, att, rel = 1.0, 1.0, 1.0
    else:
        sig = rng.normal(size=shape).astype(np.float32)
        tail = rng.normal(size=shape).astype(np.float32)
        rmax, att, rel = K4_TRIPLES[case]
    scal = [np.float32(v) for v in (rmax, att, rel)]
    ref = jax_agc_overlap_add(jnp.asarray(sig), jnp.asarray(tail),
                              jnp.asarray(window),
                              *(jnp.float32(v) for v in scal),
                              interpret=True)
    got = audio_kernel.agc_overlap_add(t(sig), t(tail), t(window),
                                       *(torch.tensor(v) for v in scal))
    assert got[0].shape == shape[:-1] + (2048,)
    assert got[1].shape == shape and got[2].shape == ()
    assert np.all(np.isfinite(got[0].numpy()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)


@pytest.mark.parametrize("order", ["frame", "chunk", "frames"])
@pytest.mark.parametrize("channels", [1, 2])
def test_k4_stream_axis_plain_equals_per_stream_calls(rng, order, channels):
    """K4's stream axis on the CPU: the plain version on S = 3 streams of
    very different loudness, each with its own tail, running max, attack
    and release, equals 3 calls on each stream alone, bit for bit."""
    fn, plain, frames_of = k4_stream_forms(order)
    sig, tail, window, *scal = k4_stream_args(rng, 3, 4, channels)
    got = fn(frames_of(sig), tail, window, *scal)
    assert got[2].shape == (3,)
    for s in range(3):
        one = plain(frames_of(sig)[s], tail[s], window,
                    *(x[s] for x in scal))
        for g, r in zip(got, one):
            assert torch.equal(g[s], r)


@pytest.mark.parametrize("channels", [1, 2])
def test_k4_stream_axis_matches_vmap_of_the_pallas_kernel(rng, channels):
    """K4's frame order on a stream axis against jax.vmap of the TPU
    kernel (interpret mode): a batching rule that adds a grid axis, as the
    JAX pod runs it; pcm and tail within 1e-6, running max rtol 1e-6."""
    sig, tail, window, *scal = k4_stream_args(rng, 3, 1, channels)
    got = audio_kernel.agc_overlap_add(sig[:, 0], tail, window, *scal)
    ref = jax.vmap(lambda x, t, r, a, l: jax_agc_overlap_add(
        x, t, jnp.asarray(hann_window_norm(4096)), r, a, l,
        interpret=True))(*(jnp.asarray(x.numpy()) for x in
                           (sig[:, 0], tail, *scal)))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-6)


def test_k4_plain_equals_the_unfused_tail(rng):
    """Without K4 the per-frame step runs dsp.agc_normalize + overlap_add,
    whose sigmoid divides by g1 - g0 rounded once from f64; K4 (as the TPU
    kernel) subtracts the f32-rounded bounds.  Both give the same f32
    value, and the two tails agree bit for bit."""
    from vaudio_torch.dsp.core import agc_normalize, overlap_add
    sig = t(rng.normal(size=(2, 4096)).astype(np.float32))
    tail = t(rng.normal(size=(2, 4096)).astype(np.float32))
    window = t(hann_window_norm(4096))
    one = torch.tensor(np.float32(1.0))
    att = torch.tensor(np.float32(0.5))
    pcm, new_tail, new_max = audio_kernel.agc_overlap_add(
        sig, tail, window, one, att, att)
    norm, max2 = agc_normalize(sig, one, att, att)
    pcm2, tail2 = overlap_add(norm, tail, window)
    assert float(new_max) == float(max2)
    np.testing.assert_array_equal(pcm.numpy(), pcm2.numpy())
    np.testing.assert_array_equal(new_tail.numpy(), tail2.numpy())
    assert audio_kernel._G1_MINUS_G0 == np.float32(
        (1.0 / (1.0 + np.exp(-1.0))) - (1.0 / (1.0 + np.exp(1.0))))


def bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("channels", [1, 2])
def test_k4_chunk_plain_equals_chained_frames(rng, channels):
    """A call on T=8 frames equals 8 chained T=1 calls of itself, carrying
    the running max and the tail, bit for bit: what the CUDA kernel's
    one-launch recurrence must reproduce."""
    args = k4_args(rng, 8, channels)
    pcm, new_tail, new_max = audio_kernel.agc_overlap_add_chunk(*args)
    assert pcm.shape == (8, 2048) + ((channels,) if channels > 1 else ())
    p, tl, rm = k4_chained(audio_kernel.agc_overlap_add_chunk, *args)
    assert torch.equal(bits(p), bits(pcm))
    assert torch.equal(bits(tl), bits(new_tail))
    assert torch.equal(bits(rm), bits(new_max))


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_k4_frames_plain_equals_chained_frames(rng, channels, T):
    """K4's frame order at T frames (the OrthoModes chunk step's tail): the
    plain version on T frames equals T chained one-frame calls of
    ``agc_overlap_add`` (as frame_step calls it), carrying the running max
    and the tail, bit for bit; and so the unfused agc_normalize +
    overlap_add of the JAX OrthoModes step."""
    from vaudio_torch.dsp.core import agc_normalize, overlap_add
    args = k4_args(rng, T, channels)
    pcm, new_tail, new_max = audio_kernel.agc_overlap_add_frames(*args)
    assert pcm.shape == (T, 2048) + ((channels,) if channels > 1 else ())
    chained = k4_chained(k4_forms("frame")[0], *args)
    for a, b in zip((pcm, new_tail, new_max), chained):
        assert torch.equal(bits(a), bits(b))
    sig, tail, window, rmax, att, rel = args
    for k in range(T):
        norm, rmax = agc_normalize(sig[k], rmax, att, rel)
        out, tail = overlap_add(norm, tail, window)
        assert torch.equal(bits(out if channels == 1 else out.T),
                           bits(pcm[k]))
    assert torch.equal(bits(tail), bits(new_tail))
    assert torch.equal(bits(rmax), bits(new_max))


# Carried running maxima: ordinary, tiny, infinite, NaN, and negative (which
# drives the sigmoid below g(0): norm = 0, so peak / norm = inf).
K4_EDGE_RMAX = [1.0, 0.3, 1e-30, np.inf, np.nan, -1.0]


@pytest.mark.parametrize("order", ["chunk", "frame"])
@pytest.mark.parametrize("rmax", K4_EDGE_RMAX)
def test_k4_second_peak_follows_from_the_first(rng, order, rmax):
    """The CUDA kernel takes one max reduction a frame: max|y| of the
    normalised frame y from m = max|x| alone, as csrc/audio_kernel.cu's
    frame_scalars does (chunk order: m * s where m is finite, else 0; frame
    order: m / v where m is finite and v is not NaN, else 0).  Rounding is
    monotone and sign-symmetric, so this equals the reduction bit for bit,
    in torch f32, on random and edge frames."""
    rm = torch.tensor(np.float32(rmax))
    for x in t(k4_edge_frames(rng)):
        m = torch.amax(torch.abs(x))
        p = m + 1e-9
        attacked = 0.5 * p + (1.0 - 0.5) * rm
        released = 0.2 * p + (1.0 - 0.2) * rm
        new_max = torch.where(p > rm, attacked, released)
        norm = torch.clamp(sigmoid_normalize(p, new_max), 0.0, 1.0)
        v = p / norm
        if order == "chunk":
            inv = 1.0 / v
            sc = torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))
            y = x * sc
            derived = torch.where(torch.isfinite(m), m * sc,
                                  torch.zeros_like(m))
        else:
            sc = v
            y = x / sc
            derived = torch.where(torch.isfinite(m) & ~torch.isnan(sc),
                                  m / sc, torch.zeros_like(m))
        y = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
        reduced = torch.amax(torch.abs(y))
        assert torch.equal(bits(derived), bits(reduced)), \
            (order, rmax, float(m), float(sc), float(reduced),
             float(derived))


@pytest.mark.parametrize("order", ["chunk", "frame"])
def test_k4_chunk_plain_edge_frames_stay_finite(rng, order):
    """The edge frames chained one by one through the frame order and the
    chunk order: the pcm and tail are finite (non-finite samples become
    0); in the chunk order one call on them all gives the same bits."""
    sig = t(k4_edge_frames(rng))
    tail = t(rng.normal(size=(2, 4096)).astype(np.float32))
    args = [sig, tail, t(hann_window_norm(4096))] + [
        torch.tensor(np.float32(v)) for v in (1.0, 0.5, 0.2)]
    pcm, new_tail, new_max = k4_chained(k4_forms(order)[0], *args)
    assert pcm.shape == (sig.shape[0], 2048, 2)
    assert bool(torch.isfinite(pcm).all()) and bool(
        torch.isfinite(new_tail).all())
    if order == "chunk":
        whole = audio_kernel.agc_overlap_add_chunk(*args)
        assert all(torch.equal(bits(a), bits(b))
                   for a, b in zip(whole, (pcm, new_tail, new_max)))


def test_cpu_tensors_take_the_plain_versions_without_counting(rng):
    frames = t(rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
    pf, scale, w = k2_inputs(rng, 1, 2)
    mods = (pool_kernel, spectrum_kernel, vision_kernel, audio_kernel)
    before = [m.launches for m in mods]
    k1_before = (pool_kernel.planar_launches, pool_kernel.yuv_launches)
    pool_kernel.mip_pool(frames, 3, 1 / 255.0)
    pool_kernel.mip_pool_planes(frames[..., 0], 3)
    pool_kernel.mip_pool_yuv420(frames[..., 0], frames[:, :16, :16, 1],
                                frames[:, :16, :16, 2], 3)
    spectrum_kernel.hann_peak_weighted_sum(t(CFG.bin_frequencies()), t(pf),
                                           t(scale), t(w))
    vision_kernel.vision_stats(t(k3_mips(rng, (16, 16))[None]), CFG)
    z = torch.zeros(4096)
    audio_kernel.agc_overlap_add(z, z, z, torch.tensor(1.0),
                                 torch.tensor(1.0), torch.tensor(1.0))
    audio_kernel.agc_overlap_add_chunk(z[None], z, z, torch.tensor(1.0),
                                       torch.tensor(1.0), torch.tensor(1.0))
    audio_kernel.agc_overlap_add_frames(z[None], z, z, torch.tensor(1.0),
                                        torch.tensor(1.0), torch.tensor(1.0))
    assert [m.launches for m in mods] == before
    assert (pool_kernel.planar_launches, pool_kernel.yuv_launches) == \
        k1_before


def test_wrappers_raise_for_a_device_without_kernel():
    """No fallback: a tensor that is neither on the CPU nor on CUDA raises
    (the meta device stands in for any other)."""
    meta = torch.empty((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pool_kernel.mip_pool(meta, 3)
    with pytest.raises(ValueError, match="no kernel"):
        pool_kernel.mip_pool_yuv420(meta[..., 0], meta[:, :8, :8, 1],
                                    meta[:, :8, :8, 2], 3)
    f = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spectrum_kernel.hann_peak_weighted_sum(
            f, torch.empty((1, 4), device="meta"),
            torch.empty((1, 4), device="meta"),
            torch.empty((1, 4, 2), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        vision_kernel.vision_stats(torch.empty((1, 3, 16, 16),
                                               device="meta"), CFG)
    sig = torch.empty(4096, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        audio_kernel.agc_overlap_add(sig, sig, sig, *(torch.empty(
            (), device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="no kernel"):
        audio_kernel.agc_overlap_add_chunk(sig[None], sig, sig, *(
            torch.empty((), device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="no kernel"):
        audio_kernel.agc_overlap_add_frames(sig[None], sig, sig, *(
            torch.empty((), device="meta") for _ in range(3)))


def test_build_is_keyed_by_the_sources():
    """The library path is under build/vaudio_torch/<hash of the CUDA
    sources and flags>/; nothing is compiled to compute it."""
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert {p.name for p in _build._sources()} >= {
        "pool_kernel.cu", "spectrum_kernel.cu", "vision_kernel.cu",
        "audio_kernel.cu"}
    assert path == _build.library_path()


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_129hann_peak_weighted_sum_kernelILi4EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FRND R5, R4 ;
        /*0030*/                   FADD R6, R4, -R5 ;
        /*0040*/                   FRND R7, R3 ;
        /*0050*/                   FFMA R8, R6, R7, R8 ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   BRA 0x70 ;
        /*0080*/                   EXIT ;
"""


def test_sass_loop_count():
    """The SASS counter finds the loop (a branch back to a lower address)
    and counts its instructions per marker opcode."""
    from vaudio_torch.ops import sass
    funcs = sass.parse(SASS)
    (name, insns), = funcs.items()
    assert "hann_peak" in name and len(insns) == 9
    spin, body = sass.loops(insns, marker="FRND")
    assert spin["instructions"] == 1 and spin["per_marker"] is None
    assert (body["start"], body["end"]) == ("0x20", "0x60")
    assert body["instructions"] == 5 and body["markers"] == 2
    assert body["per_marker"] == 2.5
    assert body["by_opcode"] == {"FRND": 2, "FADD": 1, "FFMA": 1, "BRA": 1}
