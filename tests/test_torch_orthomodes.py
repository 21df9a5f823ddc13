"""The port's OrthoModes family (vaudio_torch.models.orthomodes and the
OrthoModesEngine behind the stream, the API, the checkpoints and the
server) against the JAX package on the CPU, at small shapes.

The bands, each measured over seeds 0-5 on the shapes below and held here
with headroom:

- u8 frames: the mip (K1's interleaved route) bit-equal to the JAX
  package's integer pool; A and Q bit-equal to eager JAX; f0 within
  2e-4 Hz (measured 9.2e-5, 3 ulp): XLA's arccos is an atan2 of its own
  and torch.acos differs from it by up to 2 ulp.
- f32 frames: the banded f32 matmuls sum in another order, A within 2e-4
  (6.1e-5), Q within 2e-6 (5.3e-7), f0 within 1e-2 Hz (3.4e-3: near-grey
  pixels, where arccos amplifies an ulp of its argument).
- synthesize_spectrum on shared inputs: within 2e-6 of the spectrum's peak
  (2.3e-7; the 2047 x P contraction sums in another order).
- The phase recurrence equals XLA:CPU's fused multiply-add bit for bit.
- The jitted JAX scan against the port: the f0 differences above (and
  XLA's FMAs on the mip epilogue and f0) drift the phases, 4 frames within
  5e-3 rad (1.2e-3), the spectrum within 1e-3 of its peak (2.2e-4), the
  tail within 5e-4 (1.6e-4), the running max within 1e-4 relative
  (3.2e-5); 12 frames of PCM within 5e-4 (1.7e-4 at a peak of ~1.6).
"""

import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vaudio.models.orthomodes as jax_ortho
from torch_frames import rgb_to_yuv420, structured_frames, yuv420_bytes
from vaudio.api import Auralizer as JaxAuralizer
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.dsp import hann_window_norm
from vaudio.runtime import checkpoint as jax_checkpoint
from vaudio.runtime.engine import make_engine as jax_make_engine
from vaudio.vision.features import mip_downsample_planes as jax_mip
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import PushSource
from vaudio_torch.io.push import push_frames
from vaudio_torch.models import orthomodes
from vaudio_torch.models.orthomodes import (ModeMultipliers, OrthoCarry,
                                            OrthoModesConfig, OrthoModesModel)
from vaudio_torch.runtime import checkpoint
from vaudio_torch.runtime.engine import OrthoModesEngine, make_engine
from vaudio_torch.vision.features import mip_downsample_planes

TIMEOUT = 60.0
# (H, W, mip level): 12 x 16 = 192 oscillators, and 4 x 8 = 32 at level 5.
SHAPES = [(96, 128, 3), (128, 256, 5)]
MULTS = {"breathing": np.float32(0.3), "vertical_tilt": np.float32(0.7),
         "horizontal_tilt": np.float32(-0.2), "shear": np.float32(0.9)}
PARAMS = {**MULTS, "spectrum_mixing": np.float32(0.9),
          "attack": np.float32(0.6), "release": np.float32(0.3)}
PCM_ATOL = 5e-4          # the port against the jitted JAX scan (docstring)


def models(level):
    return (jax_ortho.OrthoModesModel(jax_ortho.OrthoModesConfig(
                mip_level=level)),
            OrthoModesModel(OrthoModesConfig(mip_level=level),
                            device="cpu"))


def u8_clip(seed, T, H, W):
    return np.random.default_rng(seed).integers(
        0, 256, (T, H, W, 3)).astype(np.uint8)


def jax_scan(model, carry, frames, params):
    """The JAX package's jitted scan of frame_step (OrthoModesModel.sonify's
    own), from ``carry``: (final carry, pcm f32[T, hop])."""
    window = jnp.asarray(hann_window_norm(model.cfg.audio.nfft))

    def scan_fn(carry, frames):
        return jax.lax.scan(
            lambda c, f: model.frame_step(c, f, params, window), carry,
            frames)
    return jax.jit(scan_fn)(carry, jnp.asarray(frames))


def circular(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d).max()


# ---------------------------------------------------------------------------
# The model's modules against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,level", SHAPES)
def test_extract_pixel_modes_u8_matches_eager_jax(H, W, level):
    frame = u8_clip(0, 1, H, W)[0]
    ref = [np.asarray(x) for x in jax_ortho.extract_pixel_modes(
        jnp.asarray(frame), MULTS, jax_ortho.OrthoModesConfig(
            mip_level=level))]
    got = [x.numpy() for x in orthomodes.extract_pixel_modes(
        torch.as_tensor(frame), MULTS, OrthoModesConfig(mip_level=level))]
    P = (H >> level) * (W >> level)
    assert all(x.shape == (P,) and x.dtype == np.float32 for x in got)
    np.testing.assert_array_equal(got[0], ref[0])          # A
    np.testing.assert_array_equal(got[1], ref[1])          # Q
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=2e-4)
    assert got[0].max() > 0 and 0 < got[1].mean() < 1


@pytest.mark.parametrize("H,W,level", SHAPES)
def test_extract_pixel_modes_f32_matches_jax(H, W, level):
    frame = np.random.default_rng(1).random((H, W, 3), dtype=np.float32)
    ref = [np.asarray(x) for x in jax_ortho.extract_pixel_modes(
        jnp.asarray(frame), MULTS, jax_ortho.OrthoModesConfig(
            mip_level=level))]
    got = [x.numpy() for x in orthomodes.extract_pixel_modes(
        torch.as_tensor(frame), MULTS, OrthoModesConfig(mip_level=level))]
    for g, r, atol in zip(got, ref, (2e-4, 2e-6, 1e-2)):
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_a_batch_of_frames_equals_one_frame_at_a_time(dtype):
    """extract_pixel_modes on (T, H, W, 3) in one call (one K1 launch on
    the card) gives each frame's modes bit for bit."""
    frames = u8_clip(2, 4, 96, 128)
    if dtype == np.float32:
        frames = frames.astype(np.float32) / np.float32(255.0)
    cfg = OrthoModesConfig(mip_level=3)
    batch = orthomodes.extract_pixel_modes(torch.as_tensor(frames), MULTS,
                                           cfg)
    for t in range(4):
        one = orthomodes.extract_pixel_modes(torch.as_tensor(frames[t]),
                                             MULTS, cfg)
        assert all(torch.equal(b[t], o) for b, o in zip(batch, one))


@pytest.mark.parametrize("level", [1, 3, 5, 7])
def test_interleaved_k1_route_equals_the_jax_pool(level):
    """The u8 mips through K1's interleaved entry (read in place) equal
    mip_downsample_planes of the transposed planes, the JAX package's
    route, in the port and in JAX, bit for bit (odd sizes drop the ragged
    rows and columns)."""
    frames = u8_clip(3, 2, 191, 253)
    got = orthomodes.pixel_mip(torch.as_tensor(frames), level)
    planes = torch.as_tensor(frames).permute(0, 3, 1, 2)
    port = mip_downsample_planes(planes, level, scale=1.0 / 255.0)
    assert got.shape == (2, 3, 191 >> level, 253 >> level)
    assert torch.equal(got.view(torch.int32), port.view(torch.int32))
    for t in range(2):
        ref = np.asarray(jax_mip(jnp.asarray(frames[t].transpose(2, 0, 1)),
                                 level, scale=1.0 / 255.0))
        np.testing.assert_array_equal(got[t].numpy(), ref)


def test_synthesize_spectrum_matches_jax():
    rng = np.random.default_rng(4)
    jm, tm = models(5)
    P = 240
    args = [rng.uniform(0, 255, P), rng.uniform(0, 1, P),
            rng.uniform(400, 790, P), rng.uniform(0, 2 * np.pi, P),
            1e-3 * rng.standard_normal((2047, 2))]
    args = [a.astype(np.float32) for a in args]
    mixing = np.float32(0.9)
    ref = np.asarray(jax_ortho.synthesize_spectrum(
        *map(jnp.asarray, args), jnp.float32(mixing), jm.cfg, jm._consts(P)))
    got = orthomodes.synthesize_spectrum(
        *map(torch.as_tensor, args), torch.tensor(mixing), tm.cfg,
        tm._consts(P)).numpy()
    assert got.shape == (2047, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_consts_equal_the_jax_package_bytes():
    """The hash phases stay host-side f64, cast to f32 once: the port's
    constants are the JAX package's bytes; inv_bw and the 1/255/P norm are
    its f32 host scalars."""
    jm, tm = models(5)
    for P in (32, 1980):
        ref, got = jm._consts(P), tm._consts(P)
        for k in ("freqs", "static_cos", "static_sin", "seed_phase"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
        assert got["norm"] == np.float32(1.0 / 255.0) / np.float32(P)
        assert got["inv_bw"] == np.float32(
            1.0 / (jm.cfg.audio.bin_width * jm.cfg.bandwidth))


def test_phase_recurrence_is_xla_fused_multiply_add():
    """The phase recurrence equals the JAX expression (orthomodes.py:256-
    257) jitted, which XLA:CPU contracts into one FMA, bit for bit; eager
    JAX rounds twice and differs in about a quarter of the cases."""
    rng = np.random.default_rng(5)
    acfg = JaxConfig()
    phases = rng.uniform(0, 2 * np.pi, 200_000).astype(np.float32)
    f0 = rng.uniform(400, 790, 200_000).astype(np.float32)
    c = np.float32(2.0 * np.pi * acfg.hop_size / acfg.sample_rate)

    def jax_step(p, f):
        return jnp.mod(p + c * f, jax_ortho._TWO_PI)
    fused = np.asarray(jax.jit(jax_step)(phases, f0))
    eager = np.asarray(jax_step(jnp.asarray(phases), jnp.asarray(f0)))
    got = orthomodes.advance_phases(torch.as_tensor(phases),
                                    torch.as_tensor(f0),
                                    AuralizerConfig()).numpy()
    np.testing.assert_array_equal(got, fused)
    assert np.mean(got != eager) > 0.1


@pytest.mark.parametrize("H,W,level", SHAPES)
def test_frame_step_carries_match_jax(H, W, level):
    """Four frame steps from a cold carry against the JAX package's jitted
    step: every carry field within its band (module docstring)."""
    jm, tm = models(level)
    P = tm.num_oscillators(H, W)
    jc, tc = jm.init_carry(P), tm.init_carry(P)
    window = jnp.asarray(hann_window_norm(4096))
    step = jax.jit(lambda c, f: jm.frame_step(c, f, PARAMS, window))
    for frame in u8_clip(6, 4, H, W):
        jc, jpcm = step(jc, jnp.asarray(frame))
        tc, tpcm = tm.frame_step(tc, frame, PARAMS)
    assert isinstance(tc, OrthoCarry) and tc.phases.shape == (P,)
    assert circular(tc.phases.numpy(), jc.phases) <= 5e-3
    spec = np.asarray(jc.prev_spectrum)
    np.testing.assert_allclose(tc.prev_spectrum.numpy(), spec, rtol=0,
                               atol=1e-3 * np.abs(spec).max())
    np.testing.assert_allclose(tc.ola_tail.numpy(), np.asarray(jc.ola_tail),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(float(tc.running_max),
                               float(jc.running_max), rtol=1e-4)
    np.testing.assert_allclose(tpcm.numpy(), np.asarray(jpcm), atol=PCM_ATOL)


@pytest.mark.parametrize("H,W,level", SHAPES)
@pytest.mark.parametrize("clip", ["random", "structured"])
def test_sonify_matches_jax(H, W, level, clip):
    """OrthoModesModel.sonify over 12 frames with its default params."""
    frames = (u8_clip(7, 12, H, W) if clip == "random"
              else structured_frames(7, 12, H, W))
    jm, tm = models(level)
    ref = jm.sonify(frames)
    got = tm.sonify(frames)
    assert isinstance(got, np.ndarray) and got.shape == (12 * 2048,)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=PCM_ATOL)


def test_chunk_step_equals_chained_frame_steps():
    """The chunk step (one pool for the chunk, the peaks in blocks, one
    irfft and one K4 call at T frames) equals T chained frame steps bit for
    bit, including with blocks smaller than the chunk."""
    frames = u8_clip(8, 6, 96, 128)
    _, tm = models(3)
    P = tm.num_oscillators(96, 128)
    carry, pcm = tm.init_carry(P), []
    for frame in frames:
        carry, out = tm.frame_step(carry, frame, PARAMS)
        pcm.append(out)
    for block_bytes in (orthomodes._PEAK_BLOCK_BYTES, 2047 * P * 4 * 4):
        orthomodes._PEAK_BLOCK_BYTES, saved = block_bytes, \
            orthomodes._PEAK_BLOCK_BYTES
        try:
            got, gpcm, spectra = tm.chunk_step(tm.init_carry(P), frames,
                                               PARAMS)
        finally:
            orthomodes._PEAK_BLOCK_BYTES = saved
        assert torch.equal(gpcm, torch.stack(pcm))
        assert all(torch.equal(a, b) for a, b in zip(got, carry))
        assert spectra.shape == (6, 2047, 2)
        assert torch.equal(spectra[-1], carry.prev_spectrum)


def test_sonify_in_blocks_continues_the_carry(monkeypatch):
    """sonify through blocks of 4 equals one block of 12 bit for bit."""
    frames = u8_clip(9, 12, 96, 128)
    _, tm = models(3)
    whole = tm.sonify(frames)
    monkeypatch.setattr(orthomodes, "_SONIFY_BLOCK", 4)
    np.testing.assert_array_equal(tm.sonify(frames), whole)


def test_carry_round_trip_and_jax_carry():
    """carry_to_numpy / carry_from_numpy round trip; a JAX OrthoCarry (a
    NamedTuple of jax arrays) converts field by field."""
    _, tm = models(3)
    carry, _, _ = tm.chunk_step(tm.init_carry(192), u8_clip(10, 3, 96, 128),
                                PARAMS)
    back = orthomodes.carry_from_numpy(orthomodes.carry_to_numpy(carry),
                                       "cpu")
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(carry, back))
    jc = jax_ortho.OrthoCarry(*(jnp.asarray(x.numpy()) for x in carry))
    assert all(torch.equal(a, b) for a, b in zip(
        orthomodes.carry_from_numpy(jc, "cpu"), carry))
    ref = jax_ortho.OrthoModesModel().init_carry(192)
    for name in OrthoCarry._fields:
        assert tuple(getattr(tm.init_carry(192), name).shape) == \
            np.shape(getattr(ref, name)), name


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_checkpoint_resumes_across_packages(tmp_path, saver):
    """Six frames in one package, its carry saved as .npz (the shared
    format) and resumed by the other package's engine for six more: the
    continued PCM within the scan band of the saving package continuing
    from its own carry."""
    frames = u8_clip(11, 12, 128, 256)
    jm, tm = models(5)
    path = str(tmp_path / "ortho.npz")
    P = tm.num_oscillators(128, 256)
    if saver == "port":
        carry, _, _ = tm.chunk_step(tm.init_carry(P), frames[:6], PARAMS)
        checkpoint.save_state(path, carry)
        resumed = jax_make_engine("orthomodes", JaxConfig()).load_carry(path)
        _, ref = jax_scan(jm, resumed, frames[6:], PARAMS)
        _, got, _ = tm.chunk_step(carry, frames[6:], PARAMS)
    else:
        carry, _ = jax_scan(jm, jm.init_carry(P), frames[:6], PARAMS)
        jax_checkpoint.save_state(path, carry)
        resumed = make_engine("orthomodes", AuralizerConfig(),
                              device="cpu").load_carry(path)
        assert isinstance(resumed, OrthoCarry)
        np.testing.assert_array_equal(resumed.phases.numpy(),
                                      np.asarray(carry.phases))
        _, ref = jax_scan(jm, carry, frames[6:], PARAMS)
        _, got, _ = tm.chunk_step(resumed, frames[6:], PARAMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PCM_ATOL)


# ---------------------------------------------------------------------------
# The engine behind the front doors (tests/test_engine.py:30-201)
# ---------------------------------------------------------------------------

def clip(n=6, size=64, seed=12):
    return structured_frames(seed, n, size, size)


def ortho(**kwargs):
    return Auralizer(model="orthomodes", device="cpu", **kwargs)


def run_pcm(aur, frames):
    aur.run_until_exhausted(frames, timeout=TIMEOUT)
    aur.raise_if_failed()
    pcm = aur.pull(len(frames) * 2048)
    aur.stop()
    return pcm


@pytest.mark.parametrize("chunk_frames,dispatches", [(1, 6), (3, 2), (4, 3)])
def test_stream_equals_offline_sonify(chunk_frames, dispatches):
    """The live stream, per frame and in chunks (a trailing partial chunk
    single-stepped), equals the offline sonify bit for bit, and the JAX
    package's stream within the scan band."""
    frames = clip()
    aur = ortho(chunk_frames=chunk_frames)
    pcm = run_pcm(aur, frames)
    assert aur.metrics["dispatches"] == dispatches
    np.testing.assert_array_equal(pcm, ortho().sonify(frames))
    assert np.abs(pcm).max() > 1e-3
    jaur = JaxAuralizer(model="orthomodes", chunk_frames=chunk_frames,
                        prefer_native=False)
    jaur.run_until_exhausted(frames)
    jaur.raise_if_failed()
    ref = jaur.pull(6 * 2048)
    jaur.stop()
    np.testing.assert_allclose(pcm, ref, atol=PCM_ATOL)


def test_stereo_config_coerced_to_mono():
    aur = ortho(config=AuralizerConfig(channels=2, enable_filters=True))
    assert aur.config.channels == 1 and not aur.config.enable_filters
    assert aur._stream.cfg.channels == 1
    assert ortho(config=AuralizerConfig(channels=2)).sonify(
        clip(n=2)).shape == (2 * 2048,)


def test_live_params_apply():
    frames = clip(n=4)
    fast = ortho(params=LiveParams(attack=1.0, release=1.0)).sonify(frames)
    slow = ortho(params=LiveParams(attack=0.01, release=0.01)).sonify(frames)
    assert not np.allclose(fast, slow, atol=1e-5)
    mixed = ortho(params=LiveParams(spectrum_mixing=0.0)).sonify(frames)
    assert not np.allclose(fast, mixed, atol=1e-5)


def test_resolution_change_reinits_carry():
    """A mid-stream resolution change drops the frame-sized carry and the
    next dispatch builds one at the new size: the second part's PCM equals
    a cold run on it."""
    small = clip(n=3, size=32, seed=13)
    frames = list(clip(n=3)) + list(small)
    aur = ortho()
    pcm = run_pcm(aur, frames)
    assert aur.metrics["frames_processed"] == 6
    assert aur.metrics["resolution_changes"] == 1
    np.testing.assert_array_equal(pcm[3 * 2048:], ortho().sonify(small))
    assert aur._stream.snapshot_carry().phases.shape == (1,)


def test_checkpoint_round_trip_and_cross_model_guard(tmp_path):
    frames = clip(n=4)
    aur = ortho()
    aur.run_until_exhausted(frames, timeout=TIMEOUT)
    path = str(tmp_path / "ortho.npz")
    aur.save_state(path)
    saved = dict(np.load(path))
    assert str(saved.pop("carry_type")) == "OrthoCarry"
    assert set(saved) == set(OrthoCarry._fields)
    aur.load_state(path)                       # engine-aware restore
    aur.stop()
    flag = Auralizer(device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        flag.load_state(path)                  # per-pixel carry rejected
    flag_path = str(tmp_path / "flag.npz")
    flag.save_state(flag_path)
    with pytest.raises(ValueError, match="OrthoModes"):
        ortho().load_state(flag_path)          # flagship carry rejected


def test_restored_carry_continues_the_stream(tmp_path):
    """A checkpoint taken after 4 frames and restored into a fresh stream:
    the continued PCM equals the uninterrupted stream's bit for bit."""
    frames = clip(n=8)
    whole = run_pcm(ortho(), frames)
    first = ortho()
    first.run_until_exhausted(frames[:4], timeout=TIMEOUT)
    path = str(tmp_path / "mid.npz")
    first.save_state(path)
    first.stop()
    second = ortho()
    second.load_state(path)
    np.testing.assert_array_equal(run_pcm(second, frames[4:]),
                                  whole[4 * 2048:])


def test_snapshot_before_first_frame_is_loud(tmp_path):
    aur = ortho()
    with pytest.raises(ValueError, match="first frame"):
        aur.save_state(str(tmp_path / "never.npz"))
    aur.stop()                                 # no carry: nothing to clear


def test_cross_resolution_checkpoint_fails_clearly(tmp_path):
    aur = ortho()
    aur.run_until_exhausted(clip(n=2, size=64), timeout=TIMEOUT)
    path = str(tmp_path / "r64.npz")
    aur.save_state(path)
    aur.stop()
    aur2 = ortho()
    aur2.load_state(path)                      # shapes unknowable here
    with pytest.raises(RuntimeError) as e:
        aur2.run_until_exhausted(clip(n=2, size=128), timeout=TIMEOUT)
    assert "oscillators" in str(e.value.__cause__)
    aur2.stop()
    aur3 = ortho()
    aur3.load_state(path)
    aur3.run_until_exhausted(clip(n=2, size=64), timeout=TIMEOUT)
    aur3.raise_if_failed()
    aur3.stop()


def test_inspect_frame_and_debug_sonify_guards():
    aur = ortho()
    with pytest.raises(ValueError, match="16-cell"):
        aur.inspect_frame(np.zeros((64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="debug"):
        aur.sonify(clip(n=2), debug=True)
    with pytest.raises(ValueError, match="RGB-only"):
        aur.sonify(rgb_to_yuv420(clip(n=2)))


def test_frame_error_is_engine_aware():
    aur = ortho()
    yuv = {"y": np.zeros((64, 64), np.uint8),
           "u": np.zeros((32, 32), np.uint8),
           "v": np.zeros((32, 32), np.uint8)}
    assert "RGB-only" in aur.frame_error(yuv)
    assert aur.frame_error(np.zeros((64, 64, 3), np.float32)) is None
    assert "too small" in aur.frame_error(np.zeros((16, 64, 3), np.uint8))
    assert "(H, W, 3)" in aur.frame_error(np.zeros((64, 64), np.uint8))
    flagship = Auralizer(config=AuralizerConfig(mip_level=1), device="cpu")
    assert flagship.frame_error(yuv) is None


def test_engine_and_api_default_to_the_card():
    """Without a card and without device="cpu", the per-pixel family
    raises the port's device error, as the flagship does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for make in (lambda: make_engine("orthomodes", AuralizerConfig()),
                 lambda: Auralizer(model="orthomodes"),
                 lambda: OrthoModesModel()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert isinstance(make_engine("orthomodes", AuralizerConfig(),
                                  device="cpu"), OrthoModesEngine)


def test_state_npz_before_first_frame_answers_409():
    aur = ortho()
    server = aur.serve(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "state.npz", timeout=60)
        assert e.value.code == 409
        assert "carry" in json.loads(e.value.read())["error"]
    finally:
        server.stop()


def test_push_serving_full_loop():
    """The per-pixel family behind the network front door: .npy frames
    pushed over HTTP, an I420 body answered 400 by the engine's
    frame_error, the spectrum and waveform views rendered (the hue view,
    absent for this family, 404), the PCM equal to the offline run."""
    frames = clip(n=4)
    ps = PushSource(maxsize=8, when_empty="block")
    aur = ortho(source=ps, debug=True)
    server = aur.serve(port=0)
    try:
        aur.start()
        req = urllib.request.Request(
            server.url + "frames?w=64&h=64&fmt=i420", method="POST",
            data=yuv420_bytes(rgb_to_yuv420(frames[:1]), 0))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
        assert "RGB-only" in json.loads(e.value.read())["error"]
        assert push_frames(server.url, None, frames) == 4
        deadline = time.monotonic() + TIMEOUT
        while aur.is_running and time.monotonic() < deadline:
            time.sleep(0.01)
        aur.raise_if_failed()
        assert aur.metrics["frames_processed"] == 4
        for view in ("spectrum", "waveform"):
            with urllib.request.urlopen(server.url + f"debug/{view}.png",
                                        timeout=60) as r:
                assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "debug/hue_matrix.png",
                                   timeout=60)
        assert e.value.code == 404
        with urllib.request.urlopen(server.url + "state.npz",
                                    timeout=60) as r:
            saved = np.load(io.BytesIO(r.read()))
        assert str(saved["carry_type"]) == "OrthoCarry"
        pcm = aur.pull(4 * 2048)
    finally:
        server.stop()
        aur.stop()
    np.testing.assert_array_equal(pcm, ortho().sonify(frames))


def test_served_checkpoint_restores_into_a_fresh_stream():
    """/state.npz taken from a served stream after 4 frames and posted to a
    fresh served stream: its next 4 frames equal the uninterrupted run."""
    frames = clip(n=8, seed=14)
    whole = ortho().sonify(frames)
    pcm, saved = [], None
    for part in (frames[:4], frames[4:]):
        aur = ortho(source=PushSource(maxsize=8, when_empty="block"))
        server = aur.serve(port=0)
        try:
            if saved is not None:
                req = urllib.request.Request(server.url + "state.npz",
                                             data=saved, method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert r.status == 200
            aur.start()
            push_frames(server.url, None, part)
            deadline = time.monotonic() + TIMEOUT
            while aur.is_running and time.monotonic() < deadline:
                time.sleep(0.01)
            aur.raise_if_failed()
            with urllib.request.urlopen(server.url + "state.npz",
                                        timeout=60) as r:
                saved = r.read()
            pcm.append(aur.pull(4 * 2048))
        finally:
            server.stop()
            aur.stop()
    np.testing.assert_array_equal(np.concatenate(pcm), whole)


def test_set_carry_converts_to_the_engine_carry():
    """set_carry takes a carry of either package (numpy, jax or tensors)
    and stores the engine's carry type on its device; a carry without the
    OrthoModes fields is refused."""
    aur = ortho()
    jc = jax_ortho.OrthoModesModel().init_carry(4)
    aur._stream.set_carry(jc)
    snap = aur._stream.snapshot_carry()
    assert isinstance(snap, OrthoCarry) and snap.phases.shape == (4,)
    with pytest.raises(KeyError):
        aur._stream.set_carry({"hues": np.zeros(16, np.int32)})


def test_multipliers_reach_the_model():
    """Non-default mode multipliers change A and Q, so the PCM."""
    frames = u8_clip(15, 3, 96, 128)
    cfg = OrthoModesConfig(mip_level=3)
    base = OrthoModesModel(cfg, device="cpu").sonify(frames)
    other = OrthoModesModel(cfg, ModeMultipliers(breathing=2.0, shear=-1.0),
                            device="cpu").sonify(frames)
    assert not np.allclose(base, other, atol=1e-5)
    engine = OrthoModesEngine(AuralizerConfig(), device="cpu",
                              multipliers=ModeMultipliers(breathing=2.0))
    assert engine.params_arrays(LiveParams())["breathing"] == \
        np.float32(2.0)
