"""The rest of the main path's AuralizerConfig surface in the port, against
the JAX package on the same seeded numpy inputs: the quantized mip chains
(quantize_mips, quantize_mips_int8), the spatial gradient cells
(linear_cell_grads=False), the vision debug maps and the API that exposes
them (sonify(debug=True), inspect_frame), the phase advance table
(use_phase_lut), the dense inverse DFT (use_matmul_irfft), the
lower-triangular spectrum EMA (use_matmul_ema) and the dsp helpers.

Bands, each stated where it is asserted: the integer chain, the f32
quantize chain (against EAGER JAX), the LUT table and the IDFT weights are
exact; the spatial cells rtol 1e-5 / atol 1e-6 (the one-hot products sum
in another order); the debug stencil maps atol 1e-6; the matmul EMA
spectrum 2e-6 abs; the dense irfft 1e-6 of the peak; whole pipelines hues
equal and PCM within 2e-5 (tests/test_torch_pipeline.py runs each flag
through the chunked and per-frame paths)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vaudio.dsp.core as jax_dsp
import vaudio.runtime.chunked as jax_chunked
import vaudio.runtime.step as jax_step
import vaudio.synth.spectrum as jax_spectrum
from torch_frames import structured_frames
from vaudio.api import Auralizer as JaxAuralizer
from vaudio.runtime.stream import StreamingAuralizer as JaxStream
from vaudio.synth import SynthConstants as JaxConsts
from vaudio.vision import features as jf
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp import core as dsp
from vaudio_torch.ops import vision_kernel
from vaudio_torch.runtime import chunked, step
from vaudio_torch.synth import spectrum
from vaudio_torch.vision import features as tf

CFG = AuralizerConfig()
PARAMS = LiveParams().as_arrays()
PCM_ATOL = 2e-5          # the JAX package's chunked band (test_chunked.py:20)
# Every flag of this slice at once (quantize_mips_int8 acts only with
# quantize_mips, as in the JAX package).
ALL_FLAGS = dict(quantize_mips=True, quantize_mips_int8=True,
                 linear_cell_grads=False, use_phase_lut=True,
                 use_matmul_ema=True, use_matmul_irfft=True)


def t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# Quantized mips
# ---------------------------------------------------------------------------

def test_int8_level_equals_jax_and_rounds_half_even(rng):
    """_quant_pool_level_u8 against the JAX chain and a rational oracle,
    exact; the midpoints 0.5 -> 0 and 1.5 -> 2 (half to even); an odd last
    row and column dropped."""
    m = rng.integers(0, 256, (3, 33, 49), np.uint8)
    got = tf._quant_pool_level_u8(t(m)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jf._quant_pool_level_u8(jnp.asarray(m[:, :32, :48]))))
    s = (m[:, 0:32:2, 0:48:2].astype(np.int64) + m[:, 1:32:2, 0:48:2]
         + m[:, 0:32:2, 1:48:2] + m[:, 1:32:2, 1:48:2])
    bump = ((s & 3) == 3) | (((s & 3) == 2) & (((s >> 2) & 1) == 1))
    np.testing.assert_array_equal(got, ((s >> 2) + bump).astype(np.uint8))
    mid = np.zeros((1, 2, 4), np.uint8)
    mid[0, :, 0] = 1
    mid[0, :, 2], mid[0, :, 3] = 1, (1, 3)
    assert tf._quant_pool_level_u8(t(mid))[0, 0].tolist() == [0, 2]


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("chain", ["int8", "f32 from u8", "f32 from f32"])
def test_quantized_mips_equal_eager_jax(rng, level, chain):
    """mip_downsample_planes(quantize=True), batched over T, against the
    eager JAX function frame by frame: exact.  The f32 chain divides by
    255 as a true division (on CUDA a Python-float divisor is a reciprocal
    multiply, 1 ulp off)."""
    if chain == "f32 from f32":
        planes = rng.uniform(0, 1, (2, 3, 61, 47)).astype(np.float32)
        kw = {}
    else:
        planes = rng.integers(0, 256, (2, 3, 64, 48), np.uint8)
        kw = dict(scale=1 / 255.0, quantize_int8=chain == "int8")
    got = tf.mip_downsample_planes(t(planes), level, quantize=True,
                                   **kw).numpy()
    for k in range(2):
        ref = jf.mip_downsample_planes(jnp.asarray(planes[k]), level,
                                       quantize=True, **kw)
        np.testing.assert_array_equal(got[k], np.asarray(ref))
    assert np.allclose(got * 255, np.round(got * 255), atol=1e-4)


@pytest.mark.parametrize("flags", [dict(quantize_mips=True),
                                   dict(quantize_mips=True,
                                        quantize_mips_int8=True),
                                   dict(quantize_mips_int8=True)])
def test_frame_mip_planes_quantized_equal_eager_jax(rng, monkeypatch,
                                                    flags):
    """frame_mip_planes under the quantize flags skips kernel K1, as the
    JAX package skips its pool kernel, and equals the eager JAX mips
    exactly (quantize_mips_int8 alone changes nothing)."""
    from vaudio_torch.ops import pool_kernel
    calls = []
    plain = pool_kernel.mip_pool
    monkeypatch.setattr(pool_kernel, "mip_pool",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = dataclasses.replace(CFG, **flags)
    frames = rng.integers(0, 256, (2, 48, 64, 3), np.uint8)
    got = tf.frame_mip_planes(t(frames), cfg).numpy()
    assert len(calls) == (0 if cfg.quantize_mips else 1)
    for k in range(2):
        np.testing.assert_array_equal(
            got[k], np.asarray(jf.frame_mip_planes(jnp.asarray(frames[k]),
                                                   cfg)))


# ---------------------------------------------------------------------------
# Spatial gradient cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hm,wm", [(16, 16), (24, 32), (17, 23), (135, 240)])
def test_spatial_cells_match_jax(rng, hm, wm):
    """cell_gradient_stats_planes with linear_cell_grads=False (the 4x4
    tiles of the histogram), batched, against the JAX one-hot products:
    rtol 1e-5, atol 1e-6 (f32 sums in another order)."""
    cfg = dataclasses.replace(CFG, linear_cell_grads=False)
    modes = rng.normal(0, 0.3, (2, 4, hm, wm)).astype(np.float32)
    got = tf.cell_gradient_stats_planes(t(modes), cfg).numpy()
    assert got.shape == (2, 16, 4)
    for k in range(2):
        ref = np.asarray(jf.cell_gradient_stats_planes(jnp.asarray(modes[k]),
                                                       cfg))
        np.testing.assert_allclose(got[k], ref, rtol=1e-5, atol=1e-6)


def test_spatial_cells_match_the_block_oracle(rng):
    """On a 16x16 map the tiles are 4x4 blocks: RMS, mean |.|, mean |.|,
    max |.| per block (tests/test_vision.py::test_spatial_mode's oracle),
    rtol 1e-5, atol 1e-6."""
    cfg = dataclasses.replace(CFG, linear_cell_grads=False)
    feat = rng.normal(size=(16, 16, 4)).astype(np.float32)
    got = tf.cell_gradient_stats_planes(
        t(feat.transpose(2, 0, 1))[None], cfg)[0].numpy()
    ids = jf._cell_ids_unrotated((16, 16), 4)
    for cell in range(16):
        sl = feat[ids == cell]
        np.testing.assert_allclose(
            got[cell], [np.sqrt(np.mean(sl[:, 0] ** 2)),
                        np.mean(np.abs(sl[:, 1])), np.mean(np.abs(sl[:, 2])),
                        np.max(np.abs(sl[:, 3]))], rtol=1e-5, atol=1e-6)


def test_spatial_cells_bypass_the_vision_kernel():
    """K3's supports() refuses linear_cell_grads=False, as the JAX
    kernel's does, so the torch stages run."""
    cfg = dataclasses.replace(CFG, linear_cell_grads=False,
                              use_pallas_vision=True)
    assert not vision_kernel.supports(135, 240, cfg)
    assert vision_kernel.supports(135, 240, dataclasses.replace(
        cfg, linear_cell_grads=True))


# ---------------------------------------------------------------------------
# Debug maps and the API that exposes them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas_vision", [False, True])
def test_debug_maps_match_jax(monkeypatch, use_pallas_vision):
    """frame_stats(compute_debug_maps=True), batched: the histogram exact;
    the rotated (wm, hm, 4) stencil packs of H, S and I and the mip's HSI
    within atol 1e-6 of the JAX maps; K3 bypassed with the debug maps, as
    in the JAX package."""
    calls = []
    monkeypatch.setattr(vision_kernel, "vision_stats",
                        lambda *a, **k: calls.append(1))
    cfg = dataclasses.replace(CFG, use_pallas_vision=use_pallas_vision)
    frames = structured_frames(3, 2, 192, 256)
    hist, grads, dbg = tf.frame_stats(t(frames), cfg, compute_debug_maps=True)
    assert not calls
    assert set(dbg) == {"histogram", "hue_map", "saturation_map",
                        "intensity_map", "mip_hsi"}
    for k in range(2):
        h_ref, g_ref, d_ref = jf.frame_stats(jnp.asarray(frames[k]), cfg,
                                             compute_debug_maps=True)
        np.testing.assert_array_equal(hist[k].numpy(), np.asarray(h_ref))
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g_ref),
                                   atol=1e-6)
        assert set(d_ref) == set(dbg)
        for name, ref in d_ref.items():
            assert dbg[name][k].shape == ref.shape, name
            np.testing.assert_allclose(dbg[name][k].numpy(), np.asarray(ref),
                                       atol=1e-6, err_msg=name)


def test_rotate_cw_and_extract_features_with_debug(rng):
    """rotate_cw equals the JAX rotation; extract_features with the debug
    maps gives the hues, grads and maps of the JAX pass (maps 1e-6)."""
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tf.rotate_cw(t(x)).numpy(),
                                  np.asarray(jf.rotate_cw(jnp.asarray(x))))
    frame = structured_frames(4, 1, 192, 256)[0]
    prev = rng.integers(0, 360, 16).astype(np.int32)
    hues, grads, dbg = tf.extract_features(
        t(frame), t(prev), torch.tensor(0.9), CFG, compute_debug_maps=True)
    h_ref, g_ref, d_ref = jf.extract_features(
        jnp.asarray(frame), jnp.asarray(prev), jnp.float32(0.9), CFG,
        compute_debug_maps=True)
    np.testing.assert_array_equal(hues.numpy(), np.asarray(h_ref))
    np.testing.assert_allclose(grads.numpy(), np.asarray(g_ref), atol=1e-6)
    for name, ref in d_ref.items():
        np.testing.assert_allclose(dbg[name].numpy(), np.asarray(ref),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("T", [12, 4])
def test_sonify_debug_matches_jax(T):
    """sonify(debug=True), chunked (12 frames) and per frame (4): the PCM
    equal bit for bit to debug=False; hues, grads and spectrum as numpy of
    the JAX shapes, hues equal, grads 1e-6, PCM and spectrum 2e-5."""
    cfg = AuralizerConfig(channels=2)
    frames = structured_frames(11, T, 192, 256)
    aur = Auralizer(config=cfg, device="cpu")
    pcm, dbg = aur.sonify(frames, debug=True)
    np.testing.assert_array_equal(pcm, aur.sonify(frames))
    ref_pcm, ref = JaxAuralizer(config=cfg).sonify(frames, debug=True)
    assert set(dbg) == set(ref) == {"hues", "grads", "spectrum"}
    for name in ref:
        assert isinstance(dbg[name], np.ndarray)
        assert dbg[name].shape == ref[name].shape, name
    np.testing.assert_array_equal(dbg["hues"], ref["hues"])
    np.testing.assert_allclose(dbg["grads"], ref["grads"], atol=1e-6)
    np.testing.assert_allclose(dbg["spectrum"], ref["spectrum"],
                               atol=PCM_ATOL)
    np.testing.assert_allclose(pcm, ref_pcm, atol=PCM_ATOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_inspect_frame_matches_jax(dtype):
    """inspect_frame: the JAX keys and shapes; hues equal, the maps within
    1e-6.  The hue EMA starts from the stream's hues and is not advanced.
    u8 goes in unconverted (the stream's exact integer pooling); f32 in
    [0, 1] through the banded f32 products, whose sums run in another
    order than XLA's, so the mips differ by an ulp and the hue stencils,
    differences of neighbouring hues, by up to 4e-6."""
    frame = structured_frames(12, 1, 192, 256)[0]
    atol = 1e-6
    if dtype == np.float32:
        frame = frame.astype(np.float32) / np.float32(255.0)
        atol = 4e-6
    aur = Auralizer(config=CFG, device="cpu")
    got = aur.inspect_frame(frame)
    ref = JaxAuralizer(config=CFG).inspect_frame(frame)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["hues"], ref["hues"])
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   err_msg=name)
    assert got["hue_map"].shape == (256 >> 3, 192 >> 3, 4)
    assert not np.any(aur.debug.get("hues", np.zeros(16)))
    np.testing.assert_array_equal(aur.inspect_frame(frame)["hues"],
                                  got["hues"])


# ---------------------------------------------------------------------------
# The phase advance table
# ---------------------------------------------------------------------------

def test_lut_table_equals_jax_and_the_direct_advance():
    """_phase_advance_table is byte-equal to the JAX table, and the gather
    equals the direct advance bit for bit on every hue."""
    cfg = dataclasses.replace(CFG, use_phase_lut=True)
    consts = spectrum.SynthConstants.create(cfg, "cpu")
    table = spectrum._phase_advance_table(cfg, consts)
    ref = jax_spectrum._phase_advance_table(cfg, JaxConsts.create(cfg))
    assert table.dtype == torch.float32 and table.shape == ref.shape
    assert table.numpy().tobytes() == np.asarray(ref).tobytes()
    hues = (torch.arange(368, dtype=torch.int32) % 360).reshape(23, 16)
    np.testing.assert_array_equal(
        spectrum.phase_advance(hues, cfg, consts).numpy(),
        spectrum.phase_advance(hues, CFG, consts).numpy())


def test_lut_cache_is_keyed_by_values():
    """Two constants objects of equal values share one table; a change of
    f0_base, of the sample rate or of a constant's value gives another."""
    cfg = dataclasses.replace(CFG, use_phase_lut=True)
    a, b = (spectrum._phase_advance_table(
        cfg, spectrum.SynthConstants.create(cfg, "cpu")) for _ in range(2))
    assert a is b
    for other in (dataclasses.replace(cfg, f0_base=110.0),
                  dataclasses.replace(cfg, sample_rate=48000.0)):
        c = spectrum._phase_advance_table(
            other, spectrum.SynthConstants.create(other, "cpu"))
        assert c is not a and not torch.equal(c, a)
    consts = spectrum.SynthConstants.create(cfg, "cpu")
    moved = dataclasses.replace(consts, freqs=consts.freqs * 2)
    assert not torch.equal(spectrum._phase_advance_table(cfg, moved), a)


def test_serial_lut_phases_equal_jax_bit_for_bit():
    """The per-frame scan with use_phase_lut: phases bit-equal to the JAX
    run_offline(use_phase_lut=True), which adds the gathered entry in
    plain f32 (no FMA), and PCM within 2e-5.  Without the LUT the JAX
    scan's add is contracted into an FMA, so the two configs' phases
    differ (the reference quirk the port reproduces)."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 32, 64, 3), np.uint8)
    lut = AuralizerConfig(use_phase_lut=True)
    a_ref, c_ref, _ = jax_step.run_offline(frames, lut, dict(PARAMS))
    a_got, c_got, _ = step.run_offline(frames, lut, dict(PARAMS),
                                       device="cpu")
    np.testing.assert_array_equal(c_got.phases.numpy(),
                                  np.asarray(c_ref.phases))
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    _, c_default, _ = step.run_offline(frames, CFG, dict(PARAMS),
                                       device="cpu")
    assert not torch.equal(c_default.phases, c_got.phases)


def test_cumsum_lut_equals_the_default_bit_for_bit():
    """On the chunked prefix-sum path the table changes nothing: PCM and
    phases equal to the default config bit for bit (TestPhaseLut)."""
    frames = structured_frames(13, 10, 64, 128)
    a, c, _ = chunked.run_offline_batched(frames, CFG, chunk=4, device="cpu")
    a_lut, c_lut, _ = chunked.run_offline_batched(
        frames, AuralizerConfig(use_phase_lut=True), chunk=4, device="cpu")
    np.testing.assert_array_equal(a_lut.numpy(), a.numpy())
    np.testing.assert_array_equal(c_lut.phases.numpy(), c.phases.numpy())


# ---------------------------------------------------------------------------
# dsp: the dense inverse DFT and the helpers
# ---------------------------------------------------------------------------

def test_idft_matrices_equal_jax_and_are_cached():
    """The IDFT weights byte-equal to the JAX _idft_matrices (f64 built,
    cast once), one pair per (F, nfft, device)."""
    cos_m, sin_m = dsp._idft_matrices(2047, 4096)
    ref_cos, ref_sin = jax_dsp._idft_matrices(2047, 4096)
    assert cos_m.shape == (2047, 4096) and cos_m.dtype == torch.float32
    assert cos_m.numpy().tobytes() == ref_cos.tobytes()
    assert sin_m.numpy().tobytes() == ref_sin.tobytes()
    assert dsp._idft_matrices(2047, 4096)[0] is cos_m


def test_dense_irfft_matches_jax_and_the_fft(rng):
    """irfft_from_half_dense on (T, C, F, 2) within 1e-6 of the peak of
    the JAX dense irfft and of torch.fft's irfft."""
    spec = rng.normal(0, 1, (3, 2, 2047, 2)).astype(np.float32)
    got = dsp.irfft_from_half_dense(t(spec)).numpy()
    ref = np.asarray(jax_dsp.irfft_from_half_dense(jnp.asarray(spec[..., 0]),
                                                   jnp.asarray(spec[..., 1])))
    assert got.shape == ref.shape == (3, 2, 4096)
    peak = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-6 * peak)
    np.testing.assert_allclose(got, dsp.irfft_from_half(t(spec)).numpy(),
                               atol=1e-6 * peak)


def test_dsp_helpers_match_jax(rng):
    """linspace and mirror_and_conjugate exact; linear_to_log2 within
    2 ulp of 790 (log2 implementations); hash_phase within 0.05 rad on the
    circle (an ulp of the platform's sine moves it by up to ~0.03 rad)."""
    for num in (1, 2, 7, 2047):
        np.testing.assert_array_equal(dsp.linspace(20.0, 20000.0, num),
                                      jax_dsp.linspace(20.0, 20000.0, num))
    x = rng.uniform(20, 20000, 257).astype(np.float32)
    np.testing.assert_allclose(dsp.linear_to_log2(t(x)).numpy(),
                               np.asarray(jax_dsp.linear_to_log2(x)),
                               rtol=0, atol=2 * np.spacing(np.float32(790)))
    x = rng.uniform(0, 100, 257).astype(np.float32)
    d = dsp.hash_phase(t(x)).numpy() - np.asarray(jax_dsp.hash_phase(x))
    assert np.abs(np.angle(np.exp(1j * d.astype(np.float64)))).max() < 0.05
    re, im = rng.normal(size=(2, 9)).astype(np.float32)
    got = dsp.mirror_and_conjugate(t(re), t(im)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_dsp.mirror_and_conjugate(jnp.asarray(re),
                                                     jnp.asarray(im))))


# ---------------------------------------------------------------------------
# The matmul EMA and the flags through the live paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixing,chunk", [(None, 4), (0.95, 12)])
def test_matmul_ema_spectrum_matches_jax(mixing, chunk):
    """use_matmul_ema: the chunked spectrum within 2e-6 abs of the JAX
    spectrum (torch.pow against XLA's pow may differ by an ulp), hues
    equal, PCM within 2e-5; also at spectrum_mixing 0.95 in one chunk of
    12, where the power chain m^t differs most from the serial EMA."""
    params = (LiveParams() if mixing is None
              else LiveParams(spectrum_mixing=mixing)).as_arrays()
    cfg = AuralizerConfig(use_matmul_ema=True, channels=2)
    frames = structured_frames(14, 12, 192, 256)
    a_ref, _, d_ref = jax_chunked.run_offline_batched(
        frames, cfg, dict(params), chunk=chunk, debug=True)
    a_got, _, d_got = chunked.run_offline_batched(
        frames, cfg, dict(params), chunk=chunk, debug=True, device="cpu")
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    np.testing.assert_allclose(d_got["spectrum"].numpy(),
                               np.asarray(d_ref["spectrum"]), atol=2e-6)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)


def test_matmul_ema_equals_the_serial_ema(rng):
    """_matmul_ema against the serial recurrence it replaces, 1e-6 abs
    (the reassociation)."""
    rot = torch.as_tensor(rng.normal(0, 1, (16, 2, 5, 2)).astype(np.float32))
    prev = torch.as_tensor(rng.normal(0, 1, (2, 5, 2)).astype(np.float32))
    mixing = torch.tensor(0.8)
    got = chunked._matmul_ema(rot, prev, mixing)
    ref = []
    for k in range(16):
        prev = prev * mixing + rot[k] * (1.0 - mixing)
        ref.append(prev)
    np.testing.assert_allclose(got.numpy(), torch.stack(ref).numpy(),
                               atol=1e-6)


def test_blocked_run_with_every_flag_matches_jax():
    """run_offline(block=4) over 10 frames with every flag of the slice:
    hues equal, PCM within 2e-5."""
    cfg = AuralizerConfig(channels=2, **ALL_FLAGS)
    frames = structured_frames(15, 10, 192, 256)
    a_ref, _, d_ref = jax_step.run_offline(frames, cfg, dict(PARAMS),
                                           debug=True, block=4)
    a_got, _, d_got = step.run_offline(frames, cfg, dict(PARAMS), debug=True,
                                       block=4, device="cpu")
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_the_stream_with_every_flag_matches_jax(chunk_frames):
    """The live stream per frame and in chunks of 4 with every flag of the
    slice: PCM within 2e-5 of the JAX stream's."""
    cfg = AuralizerConfig(channels=2, ring_buffer_frames=64, **ALL_FLAGS)
    frames = structured_frames(16, 10, 64, 128)
    aur = Auralizer(source=frames, config=cfg, device="cpu",
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=60)
    got = aur.pull(10 * 2048 * 2)
    assert aur.metrics["frames_processed"] == 10
    ref = JaxStream(cfg, prefer_native=False, chunk_frames=chunk_frames)
    ref.run_until_exhausted(list(frames), timeout=120)
    np.testing.assert_allclose(got, ref.pull(10 * 2048 * 2), atol=PCM_ATOL)
