"""The port's serving pod (vaudio_torch.runtime.multistream, the engines'
pod methods and checkpoint.load_state(n_streams=)) on the CPU, at small
shapes: against the JAX package's pod, against the port's own
single-stream runs, and through the lifecycle, resize, leasing,
idle-shrink, stress, checkpoint, metrics-log and per-slot-params cases of
tests/test_multistream.py and the pod cases of tests/test_engine.py.

The bands:

- The port's pod against the JAX pod, flagship, 64x64 structured u8 clips
  (each slot a different clip, one ending early): hues equal, PCM within
  2e-5, the port's own band against the JAX package's chunked path
  (tests/test_torch_stream.py; the JAX pod's own band against its offline
  runs is 2e-4, tests/test_multistream.py:58).
- OrthoModes, 96x128 at mip 3: PCM within 5e-4, the port's band against
  the jitted JAX scan (tests/test_torch_orthomodes.py).
- The port's pod against the port's single-stream runs on the CPU: equal,
  bit for bit, for both families, per frame and in chunks.
"""

import concurrent.futures as cf
import json
import random
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import vaudio.runtime.multistream as jax_multistream
from torch_frames import structured_frames, structured_yuv_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.dsp import hann_window_norm as jax_window
from vaudio.dsp.core import agc_normalize as jax_agc_normalize
from vaudio.dsp.core import overlap_add as jax_overlap_add
from vaudio.runtime import checkpoint as jax_checkpoint
from vaudio.runtime.chunked import chunk_pipeline as jax_chunk_pipeline
from vaudio.runtime.engine import make_engine as jax_make_engine
from vaudio.runtime.step import frame_step as jax_frame_step
from vaudio.runtime.step import init_carry as jax_init_carry
from vaudio.synth import SynthConstants as JaxConsts
from vaudio.synth.spectrum import spectral_filter_gain as jax_filter_gain
from vaudio.synth.spectrum import live_pan_gains as jax_live_pan_gains
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp.core import agc_normalize, hann_window_norm, overlap_add
from vaudio_torch.models.orthomodes import OrthoCarry
from vaudio_torch.runtime import MultiStreamAuralizer, checkpoint, chunked
from vaudio_torch.runtime import multistream, step
from vaudio_torch.runtime.engine import (AuralizerEngine, OrthoModesEngine,
                                         make_engine)
from vaudio_torch.synth.spectrum import (SynthConstants,
                                         filter_gain_from_params,
                                         live_pan_gains)

HOP = 2048
TIMEOUT = 120.0
PCM_ATOL = 2e-5          # the port against the JAX package (docstring)
ORTHO_ATOL = 5e-4        # OrthoModes against the jitted JAX scan
LIVE = dict(channels=2, use_pallas=True, use_pallas_vision=True)


def clips(n, T, size=64, seed=0):
    """n structured u8 clips (T, size, size, 3), one seed each."""
    return [structured_frames(seed + s, T, size, size) for s in range(n)]


def pod(cfg=None, n_streams=2, **kwargs):
    """The port's pod on the CPU (its engine on the CPU)."""
    cfg = cfg or AuralizerConfig()
    kwargs.setdefault("engine", AuralizerEngine(cfg, device="cpu"))
    return MultiStreamAuralizer(cfg, n_streams=n_streams, **kwargs)


def ortho_pod(n_streams=2, cfg=None, **kwargs):
    eng = OrthoModesEngine(cfg or AuralizerConfig(), device="cpu")
    return MultiStreamAuralizer(eng.cfg, n_streams=n_streams, engine=eng,
                                **kwargs)


def wait_done(p, timeout=TIMEOUT):
    t0 = time.monotonic()
    while p.is_running:
        if time.monotonic() - t0 > timeout:
            p.stop()
            raise TimeoutError("pod producer still running")
        time.sleep(0.005)
    p.raise_if_failed()


def wait_for(cond, p, timeout=TIMEOUT):
    t0 = time.monotonic()
    while not cond():
        p.raise_if_failed()
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


def run(p, sources):
    p.start([iter(s) for s in sources])
    wait_done(p)
    return p


def offline(clip, cfg, chunk=1, params=None, carry=None):
    """The port's single-stream run on the CPU: PCM as flat numpy."""
    if chunk == 1:
        pcm, carry, _ = step.run_offline(clip, cfg, params=params,
                                         carry=carry, device="cpu")
    else:
        pcm, carry, _ = chunked.run_offline_batched(
            clip, cfg, params=params, carry=carry, chunk=chunk,
            device="cpu")
    return pcm.numpy().reshape(-1), carry


def ortho_offline(clip, cfg, chunk, params=None):
    """The OrthoModes model's chunk steps over ``clip`` (the last chunk
    may be shorter): mono PCM as numpy."""
    model = OrthoModesEngine(cfg, device="cpu").model
    params = params or model.default_params()
    carry = model.init_carry(model.num_oscillators(*clip.shape[1:3]))
    outs = []
    for k in range(0, len(clip), chunk):
        carry, pcm, _ = model.chunk_step(carry, clip[k:k + chunk], params)
        outs.append(pcm.reshape(-1))
    return torch.cat(outs).numpy()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live,chunk", [(False, 1), (False, 3), (True, 1),
                                        (True, 3)])
def test_pod_matches_the_jax_pod(live, chunk):
    """Three slots of different clips (slot 2 ends after 4 of 6 frames, a
    dark slot): the port's pod against vaudio.runtime
    .MultiStreamAuralizer, per frame and in chunks of 3 (the partial chunk
    padded): each slot's PCM within 2e-5, the final hues equal."""
    kw = LIVE if live else {}
    srcs = clips(3, 6, seed=40)
    srcs[2] = srcs[2][:4]
    ref = jax_multistream.MultiStreamAuralizer(
        JaxConfig(**kw), n_streams=3, chunk_frames=chunk,
        prefer_native=False)
    run(ref, srcs)
    got = run(pod(AuralizerConfig(**kw), 3, chunk_frames=chunk), srcs)
    ch = 2 if live else 1
    for s, clip in enumerate(srcs):
        want = ref.pull(s, len(clip) * HOP * ch)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got.pull(s, len(clip) * HOP * ch), want,
                                   rtol=0, atol=PCM_ATOL)
    np.testing.assert_array_equal(got.snapshot_carry().hues,
                                  np.asarray(ref.snapshot_carry().hues))
    assert got.metrics.frames_processed == ref.metrics.frames_processed == 16
    assert got.metrics.dispatches == ref.metrics.dispatches
    ref.stop()
    got.stop()


@pytest.mark.parametrize("chunk", [1, 3])
def test_orthomodes_pod_matches_the_jax_pod(chunk):
    """OrthoModes, two slots of 96x128 clips at mip 3 (192 oscillators):
    the port's pod against the JAX pod within the OrthoModes band."""
    from vaudio.models.orthomodes import OrthoModesConfig as JaxOrthoCfg
    from vaudio.runtime.engine import OrthoModesEngine as JaxOrthoEngine
    from vaudio_torch.models import OrthoModesConfig
    srcs = clips(2, 6, size=96, seed=50)
    srcs = [np.ascontiguousarray(np.pad(c, ((0, 0), (0, 0), (0, 32), (0, 0)),
                                        mode="edge")) for c in srcs]
    jcfg, cfg = JaxConfig(), AuralizerConfig()
    jeng = JaxOrthoEngine(jcfg, model_cfg=JaxOrthoCfg(audio=jcfg,
                                                      mip_level=3))
    eng = OrthoModesEngine(cfg, model_cfg=OrthoModesConfig(audio=cfg,
                                                           mip_level=3),
                           device="cpu")
    ref = run(jax_multistream.MultiStreamAuralizer(
        jeng.cfg, n_streams=2, engine=jeng, chunk_frames=chunk,
        prefer_native=False), srcs)
    got = run(MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                   chunk_frames=chunk), srcs)
    for s in range(2):
        want = ref.pull(s, 6 * HOP)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got.pull(s, 6 * HOP), want, rtol=0,
                                   atol=ORTHO_ATOL)
    assert got.snapshot_carry().phases.shape == (2, 12 * 16)
    ref.stop()
    got.stop()


@pytest.mark.parametrize("family", ["auralizer", "orthomodes"])
def test_init_carry_batch_matches_jax(family):
    frame = clips(1, 1)[0][0]
    ref = jax_make_engine(family, JaxConfig()).init_carry_batch(3, frame)
    got = make_engine(family, AuralizerConfig(),
                      device="cpu").init_carry_batch(3, frame)
    assert type(got).__name__ == type(ref).__name__
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)
        assert g.is_contiguous()


def _random_carry(carry, rng):
    """``carry`` (numpy fields) filled with random values of its dtypes."""
    return type(carry)(*[
        (rng.integers(0, 360, np.shape(x)).astype(np.int32)
         if np.asarray(x).dtype == np.int32
         else rng.normal(size=np.shape(x)).astype(np.float32))
        for x in carry])


@pytest.mark.parametrize("family", ["auralizer", "orthomodes"])
def test_pod_checkpoints_cross_both_packages(tmp_path, family):
    """A pod checkpoint of 3 streams written by either package loads in the
    other, fields bit-equal (load_carry_batch, and the flagship's
    checkpoint.load_state(n_streams=)); a wrong pod size or family raises
    in both."""
    rng = np.random.default_rng(3)
    frame = clips(1, 1)[0][0]
    jeng = jax_make_engine(family, JaxConfig())
    eng = make_engine(family, AuralizerConfig(), device="cpu")
    carry = _random_carry(jeng.init_carry_batch(3, frame), rng)
    jax_path, port_path = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_checkpoint.save_state(jax_path, carry)
    got = eng.load_carry_batch(jax_path, 3)
    for g, r in zip(got, carry):
        assert g.dtype == torch.as_tensor(r).dtype
        np.testing.assert_array_equal(g.numpy(), r)
    checkpoint.save_state(port_path, got)
    back = jeng.load_carry_batch(port_path, 3)
    for g, r in zip(back, carry):
        np.testing.assert_array_equal(np.asarray(g), r)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="pod size"):
            e.load_carry_batch(port_path, 2)
    other = make_engine("orthomodes" if family == "auralizer"
                        else "auralizer", AuralizerConfig(), device="cpu")
    with pytest.raises(ValueError, match="carry"):
        other.load_carry_batch(port_path, 3)
    if family == "auralizer":
        cfg = AuralizerConfig()
        flat = checkpoint.load_state(jax_path, cfg, "cpu", n_streams=3)
        ref = jax_checkpoint.load_state(jax_path, JaxConfig(), n_streams=3)
        for g, r in zip(flat, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        with pytest.raises(ValueError, match="pod size"):
            checkpoint.load_state(jax_path, cfg, "cpu", n_streams=4)
        with pytest.raises(ValueError, match="pod size"):
            jax_checkpoint.load_state(jax_path, JaxConfig(), n_streams=4)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 12), free=st.sets(st.integers(0, 12)),
       stop=st.integers(0, 13), held=st.sets(st.integers(0, 12)),
       mesh_step=st.one_of(st.none(), st.integers(1, 4)))
def test_trailing_shrink_target_matches_jax(n, free, stop, held, mesh_step):
    """The port's derivation against the JAX function, with and without a
    mesh pod's stream-axis rounding (``mesh_step``)."""
    def keep(i):
        return i in held
    for k in (None, keep):
        got = multistream.trailing_shrink_target(n, free, stop, k,
                                                 mesh_step=mesh_step)
        assert got == jax_multistream.trailing_shrink_target(
            n, free, stop, k, mesh_step=mesh_step)
        if mesh_step is not None:
            assert got % mesh_step == 0 and got >= mesh_step


def test_metrics_surface_matches_jax():
    """metrics_dict and stream_metrics carry the JAX pod's keys (and the
    port's two staging counters), and the frame signature its format."""
    srcs = clips(2, 2)
    ref = run(jax_multistream.MultiStreamAuralizer(
        JaxConfig(), n_streams=2, prefer_native=False), srcs)
    got = run(pod(n_streams=2), srcs)
    jm, pm = ref.metrics_dict(), got.metrics_dict()
    assert set(pm) == set(jm) | {"staging_allocs", "staging_reuses"}
    assert set(pm["slots"][0]) == set(jm["slots"][0])
    assert pm["frame_sig"] == jm["frame_sig"]
    for k in ("n_streams", "frames_processed", "dispatches", "free_slots"):
        assert pm[k] == jm[k]
    assert got.check_frame(np.zeros((32, 32, 3), np.uint8)) \
        .split(":")[0] == ref.check_frame(
            np.zeros((32, 32, 3), np.uint8)).split(":")[0]
    ref.stop()
    got.stop()


def _jax_vmap(fn, *args):
    return jax.vmap(fn)(*(np.asarray(a) for a in args))


def test_stream_axis_tail_pieces_match_jax_vmap(rng):
    """The unfused tail's stream axis (agc_normalize, overlap_add) against
    jax.vmap of the JAX functions: 3 streams of very different loudness,
    each with its own running max, attack and release."""
    sig = rng.normal(size=(3, 2, 4096)).astype(np.float32) \
        * np.float32([[[1e-3]], [[1.0]], [[50.0]]])
    tail = rng.normal(size=(3, 2, 4096)).astype(np.float32)
    rm, att, rel = (np.float32(v) for v in ([0.5, 2.0, 0.01],
                                            [1.0, 0.3, 0.6],
                                            [0.2, 1.0, 0.9]))
    norm, new_max = agc_normalize(*(torch.as_tensor(x) for x in
                                    (sig, rm, att, rel)))
    jnorm, jmax = _jax_vmap(jax_agc_normalize, sig, rm, att, rel)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(new_max.numpy(), np.asarray(jmax), rtol=1e-6)
    window = hann_window_norm(4096)
    got = overlap_add(norm, torch.as_tensor(tail), torch.as_tensor(window),
                      stream_axis=True)
    ref = jax.vmap(jax_overlap_add, in_axes=(0, 0, None))(
        np.asarray(jnorm), tail, jax_window(4096))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    for s in range(3):             # each stream as a single stream
        one = agc_normalize(*(torch.as_tensor(x[s]) for x in
                              (sig, rm, att, rel)))
        assert torch.equal(one[0], norm[s]) and torch.equal(one[1],
                                                            new_max[s])


def test_stream_axis_params_match_jax_vmap():
    """Per-stream live params against jax.vmap of the JAX functions: the
    pan gains (width and angles per stream) and the filter gains."""
    cfg, jcfg = AuralizerConfig(channels=2), JaxConfig(channels=2)
    width = np.float32([0.0, 0.5, 1.0])
    angles = np.linspace(0, np.pi / 2, 48, dtype=np.float32).reshape(3, 16)
    got = live_pan_gains(cfg, torch.as_tensor(width),
                         torch.as_tensor(angles), device="cpu")
    ref = jax.vmap(lambda w, a: jax_live_pan_gains(jcfg, w, a))(width,
                                                                angles)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    got = live_pan_gains(cfg, torch.as_tensor(width), device="cpu")
    ref = jax.vmap(lambda w: jax_live_pan_gains(jcfg, w))(width)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    params = {"hp_cutoff": np.float32([200.0, 900.0, 50.0]),
              "lp_cutoff": np.float32([18000.0, 4000.0, 9000.0]),
              "hp_order": np.float32([0.0, 2.0, 1.0]),
              "lp_order": np.float32([0.0, 1.0, 3.0])}
    consts = SynthConstants.create(cfg, "cpu")
    jconsts = JaxConsts.create(jcfg)
    ref = np.asarray(jax.vmap(lambda p: jax_filter_gain(
        jconsts.freqs, p["hp_cutoff"], p["lp_cutoff"], p["hp_order"],
        p["lp_order"]))(params))[..., None]             # (S, F, 1)
    for ch in (1, 2):
        got = filter_gain_from_params(
            {k: torch.as_tensor(v) for k, v in params.items()}, consts, ch)
        want = ref[:, None] if ch == 2 else ref
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _stacked_params(cfg, rows):
    return {k: np.stack([r.as_arrays()[k] for r in rows])
            for k in rows[0].as_arrays()}


@pytest.mark.parametrize("chunk", [1, 3])
def test_stream_batched_steps_match_jax_vmap(chunk):
    """The stream-batched frame step and chunk pipeline on 3 streams with
    different params (mixing, attack, release, width, filters) against
    jax.jit(jax.vmap(...)) of the JAX package's frame_step /
    chunk_pipeline, as the JAX pod runs them: hues equal, PCM within
    2e-5."""
    kw = dict(channels=2, enable_filters=True)
    cfg, jcfg = AuralizerConfig(**kw), JaxConfig(**kw)
    rows = [LiveParams(spectrum_mixing=m, attack=a, release=r,
                       stereo_width=w, hp_cutoff=h)
            for m, a, r, w, h in ((0.9, 1.0, 1.0, 1.0, 200.0),
                                  (0.5, 0.3, 0.7, 0.0, 800.0),
                                  (0.95, 0.6, 0.1, 0.5, 50.0))]
    params = _stacked_params(cfg, rows)
    frames = np.stack(clips(3, chunk, seed=60))       # (S, T, H, W, 3)
    consts = SynthConstants.create(cfg, "cpu")
    jconsts = JaxConsts.create(jcfg)
    window = torch.as_tensor(hann_window_norm(cfg.nfft))
    carry = AuralizerEngine(cfg, device="cpu").init_carry_batch(3)
    jcarry = jax.tree.map(lambda x: np.broadcast_to(
        x, (3,) + x.shape).copy(), jax_init_carry(jcfg))
    fn = step.frame_step if chunk == 1 else chunked.chunk_pipeline
    jfn = jax_frame_step if chunk == 1 else jax_chunk_pipeline
    tframes = torch.as_tensor(frames[:, 0] if chunk == 1 else frames)
    # jitted, as the JAX pod runs it: XLA:CPU's fusions contract the phase
    # multiply-add into an FMA, which the port reproduces.
    jstep = jax.jit(jax.vmap(lambda c, f, p: jfn(
        c, f, p, jcfg, jconsts, jax_window(jcfg.nfft))))
    for _ in range(2):             # twice: the carry threads through
        carry, out = fn(carry, tframes,
                        step.params_to_device(params, cfg, "cpu"), cfg,
                        consts, window)
        jcarry, jout = jstep(jcarry, np.asarray(tframes), params)
        np.testing.assert_array_equal(carry.hues.numpy(),
                                      np.asarray(jcarry.hues))
        np.testing.assert_allclose(out["pcm"].numpy(),
                                   np.asarray(jout["pcm"]), rtol=0,
                                   atol=PCM_ATOL)
    assert out["pcm"].shape == ((3, HOP, 2) if chunk == 1
                                else (3, chunk, HOP, 2))


# ---------------------------------------------------------------------------
# The port's pod against the port's single-stream runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live,chunk,yuv", [
    (False, 1, False), (False, 3, False), (True, 1, False), (True, 3, False),
    (True, 1, True), (True, 3, True)])
def test_pod_equals_single_stream_runs(live, chunk, yuv):
    """Each slot of the pod equals the port's single-stream run of its clip
    bit for bit (run_offline per frame, run_offline_batched in chunks; a
    slot ending mid-chunk equals its clip's chunked run), RGB and YUV."""
    cfg = AuralizerConfig(**(LIVE if live else {}))
    if yuv:
        full = [structured_yuv_frames(70 + s, 5, 64, 64) for s in range(3)]
        full[1] = {k: v[:4] for k, v in full[1].items()}
        sources = [[{k: v[t] for k, v in c.items()} for t in range(len(
            c["y"]))] for c in full]
    else:
        full = sources = clips(3, 5, seed=70)
        full[1] = sources[1] = full[1][:4]
    got = run(pod(cfg, 3, chunk_frames=chunk), sources)
    for s, clip in enumerate(full):
        T = len(clip["y"] if yuv else clip)
        want, _ = offline(clip, cfg, chunk)
        np.testing.assert_array_equal(
            got.pull(s, T * HOP * cfg.channels), want)
    got.stop()


@pytest.mark.parametrize("chunk", [1, 3])
def test_orthomodes_pod_equals_model_steps(chunk):
    """OrthoModes: each slot equals the model's chunk steps over its clip
    bit for bit; the frame-sized carry is built at the first tick."""
    srcs = clips(2, 6, size=64, seed=80)
    p = ortho_pod(2, chunk_frames=chunk)
    with pytest.raises(ValueError, match="no DSP carry"):
        p.snapshot_carry()
    run(p, srcs)
    cfg = p.cfg
    for s, clip in enumerate(srcs):
        np.testing.assert_array_equal(p.pull(s, 6 * HOP),
                                      ortho_offline(clip, cfg, chunk))
    assert p.snapshot_carry().phases.shape == (2, 4)
    p.stop()


def test_per_slot_params_follow_their_own_slots():
    """Three slots of one clip, each with its own params (mixing, attack,
    release, width, filters; one slot near silent): each slot's PCM equals
    the single-stream run with its own params, per frame and in chunks —
    a per-slot param never leaks into another slot's rows."""
    cfg = AuralizerConfig(channels=2, enable_filters=True,
                          use_pallas=True, ring_buffer_frames=32)
    rows = [LiveParams(spectrum_mixing=0.9),
            LiveParams(spectrum_mixing=0.4, attack=0.2, release=0.8,
                       stereo_width=0.0, hp_cutoff=900.0),
            LiveParams(spectrum_mixing=0.97, attack=0.5, release=0.05,
                       stereo_width=0.3, lp_cutoff=3000.0, lp_order=2.0)]
    clip = clips(1, 4, seed=90)[0]
    quiet = (clip // 64).astype(np.uint8)
    for chunk in (1, 2):
        p = run(pod(cfg, 3, params=rows, chunk_frames=chunk),
                [clip, clip, quiet])
        for s, (c, r) in enumerate(zip([clip, clip, quiet], rows)):
            want, _ = offline(c, cfg, chunk, params=r.as_arrays())
            np.testing.assert_array_equal(p.pull(s, 4 * HOP * 2), want)
        p.stop()


def test_engines_pod_steps_on_host_params():
    """The engines' raw steps take the stacked host params and frames on
    the engine's device and return the batch's PCM leading with S."""
    cfg = AuralizerConfig()
    frames = torch.as_tensor(np.stack(clips(2, 3)))
    params = _stacked_params(cfg, [LiveParams(), LiveParams(attack=0.5)])
    eng = AuralizerEngine(cfg, device="cpu")
    carry, out = eng.raw_chunk_step()(eng.init_carry_batch(2), frames,
                                      params)
    assert out["pcm"].shape == (2, 3, HOP) and carry.hues.shape == (2, 16)
    carry, out = eng.raw_step()(carry, frames[:, 0], params)
    assert out["pcm"].shape == (2, HOP)
    oeng = OrthoModesEngine(cfg, device="cpu")
    oparams = {k: np.stack([v, v]) for k, v in oeng.params_arrays(
        LiveParams()).items()}
    ocarry = oeng.init_carry_batch(2, frames[0, 0].numpy())
    ocarry, out = oeng.raw_chunk_step()(ocarry, frames, oparams)
    assert out["pcm"].shape == (2, 3, HOP)
    ocarry, out = oeng.raw_step()(ocarry, frames[:, 0], oparams)
    assert out["pcm"].shape == (2, HOP) and isinstance(ocarry, OrthoCarry)


# ---------------------------------------------------------------------------
# Lifecycle (tests/test_multistream.py:116-236)
# ---------------------------------------------------------------------------

class TestPodLifecycle:
    def test_uneven_lengths_dark_slot(self):
        cfg = AuralizerConfig()
        long_clip, short_clip = clips(2, 8)
        short_clip = short_clip[:4]
        p = run(pod(cfg, 2), [long_clip, short_clip])
        assert p.stream_metrics(0)["buffer_fill"] == 8
        assert p.stream_metrics(1)["buffer_fill"] == 4
        assert not p.stream_metrics(1)["active"]
        assert p.metrics.frames_processed == 12
        np.testing.assert_array_equal(p.pull(0, 8 * HOP),
                                      offline(long_clip, cfg)[0])
        p.stop()

    def test_mid_chunk_exhaust_writes_only_real_hops(self):
        cfg = AuralizerConfig()
        long_clip, short_clip = clips(2, 6)
        short_clip = short_clip[:4]
        p = run(pod(cfg, 2, chunk_frames=3), [long_clip, short_clip])
        assert p.stream_metrics(0)["buffer_fill"] == 6
        assert p.stream_metrics(1)["buffer_fill"] == 4
        np.testing.assert_array_equal(p.pull(1, 4 * HOP),
                                      offline(short_clip, cfg, 3)[0])
        p.stop()

    def test_replace_source_rearm(self):
        cfg = AuralizerConfig()
        first, second = clips(2, 3)
        p = pod(cfg, 1, exit_when_exhausted=False)
        p.start([iter(first)])
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
        assert p.is_running
        np.testing.assert_array_equal(p.pull(0, 3 * HOP),
                                      offline(first, cfg)[0])
        p.replace_source(0, iter(second), reset_carry=True)
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
        np.testing.assert_array_equal(p.pull(0, 3 * HOP),
                                      offline(second, cfg)[0])
        p.stop()
        assert not p.is_running

    def test_shape_mismatch_darkens_slot_only(self):
        a = clips(1, 4)[0]
        b = clips(1, 4, size=32)[0]
        p = run(pod(n_streams=2), [a, b])
        m = p.stream_metrics(1)
        assert m["active"] is False
        assert "signature" in m["error"]
        assert p.stream_metrics(0)["error"] is None
        assert p.rings[0].available == 4
        p.stop()

    def test_source_exception_darkens_slot_only(self):
        good = clips(1, 4)[0]

        def bad_source():
            yield good[0]
            raise OSError("camera unplugged")

        p = pod(n_streams=2, exit_when_exhausted=False)
        p.start([iter(good), bad_source()])
        wait_for(lambda: p.slot_errors[1] is not None
                 and p.rings[0].available >= 4, p)
        assert p.is_running
        assert "camera unplugged" in p.stream_metrics(1)["error"]
        p.replace_source(1, iter(good.copy()), reset_carry=True)
        wait_for(lambda: p.stream_metrics(1)["buffer_fill"] >= 4, p)
        assert p.stream_metrics(1)["error"] is None
        p.stop()


# ---------------------------------------------------------------------------
# Elastic resize (tests/test_multistream.py:239-366)
# ---------------------------------------------------------------------------

class TestPodResize:
    def test_grow_live_preserves_serving_slot(self):
        """Resize 1 -> 2 mid-stream: slot 0's PCM across the resize equals
        one uninterrupted run; the grown slot serves a fresh client."""
        cfg = AuralizerConfig()
        clip_a, clip_b = clips(2, 6)
        p = pod(cfg, 1, exit_when_exhausted=False)
        p.start([iter(clip_a[:3])])
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
        p.resize(2)
        assert p.n_streams == 2
        assert len(p.rings) == 2 and len(p.params) == 2
        m = p.stream_metrics(1)
        assert m["active"] is False and m["buffer_fill"] == 0
        p.replace_source(0, iter(clip_a[3:]))
        p.replace_source(1, iter(clip_b))
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 6, p)
        wait_for(lambda: p.stream_metrics(1)["buffer_fill"] >= 6, p)
        np.testing.assert_array_equal(p.pull(0, 6 * HOP),
                                      offline(clip_a, cfg)[0])
        np.testing.assert_array_equal(p.pull(1, 6 * HOP),
                                      offline(clip_b, cfg)[0])
        p.stop()

    def test_shrink_live_drops_highest_slots(self):
        cfg = AuralizerConfig()
        clip_a, clip_b, clip_c = clips(3, 3)
        p = pod(cfg, 3, exit_when_exhausted=False)
        p.start([iter(clip_a), iter(clip_b), iter(clip_c)])
        for s in range(3):
            wait_for(lambda s=s: p.stream_metrics(s)["buffer_fill"] >= 3, p)
        before = p.pull(0, HOP)
        p.resize(1)
        assert p.n_streams == 1
        assert len(p.rings) == 1 and len(p.params) == 1
        assert len(p.slot_errors) == 1
        got = np.concatenate([before, p.pull(0, 2 * HOP)])
        np.testing.assert_array_equal(got, offline(clip_a, cfg)[0])
        p.replace_source(0, iter(clip_a.copy()))
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
        assert p.snapshot_carry().hues.shape == (1, 16)
        p.stop()

    def test_resize_while_stopped_applies_immediately(self):
        cfg = AuralizerConfig()
        p = pod(cfg, 2)
        p.resize(3)
        assert p.n_streams == 3 and len(p.rings) == 3
        srcs = clips(3, 4)
        run(p, srcs)
        for s, clip in enumerate(srcs):
            np.testing.assert_array_equal(p.pull(s, 4 * HOP),
                                          offline(clip, cfg)[0])
        p.stop()

    def test_grow_chunked_pod(self):
        cfg = AuralizerConfig()
        clip_a, clip_b = clips(2, 4)
        p = pod(cfg, 1, chunk_frames=2, exit_when_exhausted=False)
        p.start([iter(clip_a)])
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 4, p)
        p.resize(2)
        assert p.n_streams == 2
        p.replace_source(1, iter(clip_b))
        wait_for(lambda: p.stream_metrics(1)["buffer_fill"] >= 4, p)
        np.testing.assert_array_equal(p.pull(1, 4 * HOP),
                                      offline(clip_b, cfg, 2)[0])
        p.stop()

    def test_grow_inherits_pan_angles_presence(self):
        cfg = AuralizerConfig(channels=2)
        params = [LiveParams(stereo_width=0.5) for _ in range(2)]
        for prm in params:
            prm.pan_angles = np.zeros(cfg.num_cells, np.float32)
        p = pod(cfg, 2, params=params, exit_when_exhausted=False)
        clip = clips(1, 2)[0]
        p.start([iter(clip), iter(clip.copy())])
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 2, p)
        p.resize(3)
        assert p.params[2] is not p.params[0]
        assert p.params[2].pan_angles is not None
        p.replace_source(2, iter(clip.copy()))
        wait_for(lambda: p.stream_metrics(2)["buffer_fill"] >= 2, p)
        p.stop()

    def test_resize_validation(self):
        p = pod(n_streams=2)
        with pytest.raises(ValueError, match=">= 1"):
            p.resize(0)
        with pytest.raises(ValueError, match=">= 1"):
            pod(n_streams=0)


# ---------------------------------------------------------------------------
# Slot leasing (tests/test_multistream.py:369-551)
# ---------------------------------------------------------------------------

class TestSlotLeasing:
    def test_acquire_reuses_then_grows_then_caps(self):
        cfg = AuralizerConfig()
        clip = clips(1, 2)[0]
        p = pod(cfg, 2, max_streams=3, exit_when_exhausted=False)
        p.start([iter(clip), iter(clip.copy())])
        wait_for(lambda: not any(p._active), p)
        assert p.free_slots() == [0, 1]
        s0, ps0 = p.acquire_slot()
        assert s0 == 0 and p.push_sources[0] is ps0
        s1, _ = p.acquire_slot()
        assert s1 == 1
        s2, ps2 = p.acquire_slot()
        assert s2 == 2 and p.n_streams == 3
        with pytest.raises(RuntimeError, match="at capacity"):
            p.acquire_slot()
        for fr in clip:
            ps2.push(fr)
        # past the ring's warm-up (3 hops): the held last frame repeats
        wait_for(lambda: p.stream_metrics(2)["buffer_fill"] >= 3, p)
        np.testing.assert_array_equal(p.pull(2, 2 * HOP),
                                      offline(clip, cfg)[0])
        p.stop()

    def test_release_shrinks_trailing_and_reuses_holes(self):
        clip = clips(1, 2)[0]
        p = pod(n_streams=1, max_streams=4, exit_when_exhausted=False)
        p.start([iter(clip)])
        wait_for(lambda: not any(p._active), p)
        slots = [p.acquire_slot()[0] for _ in range(3)]
        assert slots == [0, 1, 2] and p.n_streams == 3
        p.release_slot(2, shrink=True)
        assert p.n_streams == 2
        p.release_slot(0)
        wait_for(lambda: 0 in p.free_slots(), p)
        assert p.n_streams == 2
        s, _ = p.acquire_slot()
        assert s == 0 and p.n_streams == 2
        p.stop()

    def test_resize_lands_on_a_held_partial_chunk(self):
        cfg = AuralizerConfig()
        clip = clips(1, 4)[0]
        p = pod(cfg, 1, chunk_frames=3, exit_when_exhausted=False)
        p.start([iter(())])
        ps = p.arm_push(0, when_empty="dark")
        for fr in clip:
            ps.push(fr)
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
        p.resize(2, timeout=60)
        assert p.n_streams == 2
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] == 4, p)
        np.testing.assert_array_equal(p.pull(0, 4 * HOP),
                                      offline(clip, cfg, 3)[0])
        p.stop()

    def test_release_gets_fresh_ring_contract(self):
        clip = clips(1, 4)[0]
        p = pod(n_streams=1, exit_when_exhausted=False)
        p.start([iter(())])
        slot, ps = p.acquire_slot(when_empty="dark")
        for fr in clip:
            ps.push(fr)
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 4, p)
        p.release_slot(slot)
        wait_for(lambda: 0 in p.free_slots(), p)
        slot2, _ = p.acquire_slot(when_empty="dark")
        assert slot2 == slot
        m = p.stream_metrics(slot2)
        assert m["buffer_fill"] == 0
        assert m["warmed_up"] is False
        assert m["dropped_frames"] == 0
        p.stop()

    def test_lease_timeout_reaps_dead_client(self):
        clip = clips(1, 2)[0]
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False,
                lease_timeout=1.0)
        p.start([iter(())])
        slot, ps = p.acquire_slot(when_empty="dark")
        for fr in clip:
            ps.push(fr)
        wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 2, p)
        wait_for(lambda: p.leases_reaped == 1, p, timeout=30)
        wait_for(lambda: slot in p.free_slots(), p)
        assert p.metrics_dict()["leases_reaped"] == 1
        slot2, ps2 = p.acquire_slot(when_empty="dark")
        assert slot2 == slot
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.2:
            ps2.push(clip[0])
            p.raise_if_failed()
            time.sleep(0.05)
        assert not ps2.closed and p.leases_reaped == 1
        assert p.stream_metrics(slot2)["idle_s"] < 1.0
        p.stop()

    def test_operator_door_unfed_is_not_reaped(self):
        clip = clips(1, 2)[0]
        p = pod(n_streams=1, exit_when_exhausted=False, lease_timeout=0.5)
        p.start([iter(())])
        ps = p.arm_push(0, when_empty="dark")
        time.sleep(1.5)
        p.raise_if_failed()
        assert not ps.closed and p.leases_reaped == 0
        ps.push(clip[0])
        wait_for(lambda: p.leases_reaped == 1, p, timeout=30)
        assert ps.closed
        p.stop()

    def test_lease_timeout_validation(self):
        with pytest.raises(ValueError, match="lease_timeout"):
            pod(n_streams=1, lease_timeout=0.0)

    def test_max_streams_also_caps_resize(self):
        p = pod(n_streams=2, max_streams=3)
        with pytest.raises(ValueError, match="max_streams"):
            p.resize(4)
        with pytest.raises(ValueError, match="max_streams"):
            pod(n_streams=4, max_streams=2)

    def test_block_push_slots_refused(self):
        p = pod(n_streams=1)
        with pytest.raises(ValueError, match="block"):
            p.arm_push(0, when_empty="block")
        with pytest.raises(IndexError):
            p.arm_push(1)


# ---------------------------------------------------------------------------
# Idle shrink (tests/test_multistream.py:554-660)
# ---------------------------------------------------------------------------

class TestIdleShrink:
    def test_trailing_free_capacity_returns(self):
        p = pod(n_streams=1, max_streams=3, exit_when_exhausted=False,
                idle_shrink=1.0)
        p.start([iter(())])
        s0, _ = p.acquire_slot(when_empty="dark")
        s1, _ = p.acquire_slot(when_empty="dark")
        s2, _ = p.acquire_slot(when_empty="dark")
        assert (s0, s1, s2) == (0, 1, 2) and p.n_streams == 3
        p.release_slot(1)
        wait_for(lambda: 1 in p.free_slots(), p)
        time.sleep(2.2)
        p.raise_if_failed()
        assert p.n_streams == 3 and p.auto_shrinks == 0
        s1b, _ = p.acquire_slot(when_empty="dark")
        assert s1b == 1
        p.release_slot(1)
        p.release_slot(2)
        wait_for(lambda: p.n_streams == 1, p)
        assert p.auto_shrinks == 1
        assert p.metrics_dict()["auto_shrinks"] == 1
        assert not p.push_sources[0].closed
        p.stop()

    def test_reap_then_shrink_full_loop(self):
        clip = clips(1, 2)[0]
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False,
                lease_timeout=1.0, idle_shrink=1.0)
        p.start([iter(clip)])
        wait_for(lambda: not any(p._active), p)
        slot, ps = p.acquire_slot(when_empty="dark")
        assert slot == 0
        slot2, ps2 = p.acquire_slot(when_empty="dark")
        assert slot2 == 1 and p.n_streams == 2
        for fr in clip:
            ps2.push(fr)

        def alive_and(cond):
            ps.push(clip[0])
            return cond()
        wait_for(lambda: alive_and(lambda: p.leases_reaped == 1), p,
                 timeout=60)
        wait_for(lambda: alive_and(lambda: p.n_streams == 1), p,
                 timeout=60)
        assert p.auto_shrinks == 1 and not ps.closed
        p.stop()

    def test_shrink_is_counted_before_it_is_published(self):
        """An auto shrink is counted before the apply publishes the
        smaller n_streams: a slowed apply records auto_shrinks as it
        returns (already 1), and a reader that sees the pod shrunk during
        the slow-down sees the shrink counted."""
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False,
                idle_shrink=0.3)
        seen = []
        apply = p._apply_resize

        def slow_apply(n_new):
            old = p.n_streams
            apply(n_new)
            if n_new < old:
                seen.append(p.auto_shrinks)
                time.sleep(0.2)
        p._apply_resize = slow_apply
        p.start([iter(())])
        p.acquire_slot(when_empty="dark")
        s1, _ = p.acquire_slot(when_empty="dark")
        assert s1 == 1 and p.n_streams == 2
        p.release_slot(1)
        wait_for(lambda: p.n_streams == 1, p)
        assert p.auto_shrinks == 1
        assert p.metrics_dict()["auto_shrinks"] == 1
        wait_for(lambda: seen, p)
        assert seen == [1]
        p.stop()

    def test_validation(self):
        with pytest.raises(ValueError, match="idle_shrink"):
            pod(n_streams=1, idle_shrink=0.0)

    def test_stale_auto_shrink_spares_fresh_lease(self):
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False,
                idle_shrink=30.0)
        p.start([iter(())])
        p.acquire_slot(when_empty="dark")
        s1, ps1 = p.acquire_slot(when_empty="dark")
        assert s1 == 1 and p.n_streams == 2
        with p._source_lock:
            p._resize_req = (1, threading.Event(), "auto")
        wait_for(lambda: p._resize_req is None, p)
        time.sleep(0.3)
        p.raise_if_failed()
        assert p.n_streams == 2 and p.auto_shrinks == 0
        assert not ps1.closed
        p.stop()


# ---------------------------------------------------------------------------
# Stress (tests/test_multistream.py:663-816, the same seeds)
# ---------------------------------------------------------------------------

class TestElasticStress:
    def test_concurrent_acquires_get_distinct_slots(self):
        p = pod(n_streams=1, max_streams=8, exit_when_exhausted=False)
        p.start([iter(())])
        try:
            with cf.ThreadPoolExecutor(6) as ex:
                got = list(ex.map(
                    lambda _: p.acquire_slot(when_empty="dark")[0],
                    range(6)))
            assert sorted(got) == sorted(set(got)), got
            assert p.n_streams <= 8
        finally:
            p.stop()

    def test_random_ops_stress(self):
        rng = random.Random(1234)
        frame = clips(1, 1)[0][0]
        p = pod(n_streams=2, max_streams=5, exit_when_exhausted=False)
        p.start([iter(()), iter(())])
        leases = {}
        try:
            for _ in range(40):
                op = rng.choice(["acquire", "release", "resize", "push",
                                 "metrics"])
                if op == "acquire":
                    try:
                        slot, ps = p.acquire_slot(when_empty="dark")
                        leases[slot] = ps
                    except RuntimeError:
                        pass
                elif op == "release" and leases:
                    slot = rng.choice(list(leases))
                    del leases[slot]
                    if slot < p.n_streams:
                        p.release_slot(slot, shrink=rng.random() < 0.5)
                    leases = {s: q for s, q in leases.items()
                              if s < p.n_streams}
                elif op == "resize":
                    try:
                        p.resize(rng.randint(1, 5), timeout=60)
                    except ValueError:
                        pass
                    leases = {s: q for s, q in leases.items()
                              if s < p.n_streams}
                elif op == "push" and leases:
                    ps = leases[rng.choice(list(leases))]
                    if not ps.closed:
                        ps.push(frame)
                else:
                    assert len(p.metrics_dict()["slots"]) <= p.n_streams + 1
                p.raise_if_failed()
                n = p.n_streams
                assert len(p.rings) >= n and len(p.params) >= n
                assert len(p.push_sources) >= n
            assert p.is_running
        finally:
            p.stop()

    def test_random_ops_stress_with_auto_elasticity(self):
        rng = random.Random(20260819)
        frame = clips(1, 1)[0][0]
        p = pod(n_streams=2, max_streams=5, exit_when_exhausted=False,
                lease_timeout=0.4, idle_shrink=0.4)
        p.start([iter(()), iter(())])
        leases = {}
        try:
            for _ in range(60):
                op = rng.choice(["acquire", "release", "resize", "push",
                                 "sleep", "metrics"])
                if op == "acquire":
                    try:
                        slot, ps = p.acquire_slot(when_empty="dark")
                        leases[slot] = ps
                    except RuntimeError:
                        pass
                elif op == "release" and leases:
                    slot = rng.choice(list(leases))
                    del leases[slot]
                    if slot < p.n_streams:
                        try:
                            p.release_slot(slot)
                        except (TimeoutError, IndexError):
                            pass
                elif op == "resize":
                    try:
                        p.resize(rng.randint(1, 5), timeout=60)
                    except ValueError:
                        pass
                elif op == "push" and leases:
                    ps = leases[rng.choice(list(leases))]
                    if not ps.closed:
                        ps.push(frame)
                elif op == "sleep":
                    time.sleep(0.5)
                else:
                    assert 1 <= p.metrics_dict()["n_streams"] <= 5
                leases = {s: q for s, q in leases.items()
                          if s < p.n_streams and not q.closed}
                p.raise_if_failed()
                assert 1 <= p.n_streams <= 5
            assert p.is_running
            slot, ps = p.acquire_slot(when_empty="dark")
            for _ in range(3):
                ps.push(frame)
            wait_for(lambda: p.stream_metrics(slot)["buffer_fill"] >= 1, p)
        finally:
            p.stop()


# ---------------------------------------------------------------------------
# Checkpoint, metrics log, per-slot params (tests/test_multistream.py:1005-
# 1109) and the engines' pod cases (tests/test_engine.py:205-260)
# ---------------------------------------------------------------------------

class TestPodCheckpoint:
    @pytest.mark.parametrize("chunk", [1, 3])
    def test_save_load_continuity(self, tmp_path, chunk):
        """A pod split across two instances via save_state / load_state
        gives the same PCM as one continuous run, bit for bit."""
        cfg = AuralizerConfig()
        srcs = clips(2, 6)
        path = str(tmp_path / "pod.npz")
        p1 = run(pod(cfg, 2, chunk_frames=chunk), [s[:3] for s in srcs])
        first = [p1.pull(i, 3 * HOP) for i in range(2)]
        p1.save_state(path)
        p1.stop()
        p2 = pod(cfg, 2, chunk_frames=chunk)
        p2.load_state(path)
        run(p2, [s[3:] for s in srcs])
        for i, clip in enumerate(srcs):
            got = np.concatenate([first[i], p2.pull(i, 3 * HOP)])
            np.testing.assert_array_equal(got, offline(clip, cfg, chunk)[0])
        p2.stop()

    def test_load_wrong_pod_size_raises(self, tmp_path):
        path = str(tmp_path / "pod.npz")
        pod(n_streams=2).save_state(path)
        with pytest.raises(ValueError, match="pod size"):
            pod(n_streams=3).load_state(path)

    def test_metrics_log_jsonl(self, tmp_path):
        log = str(tmp_path / "pod_metrics.jsonl")
        p = run(pod(n_streams=2, metrics_log=log), clips(2, 3))
        p.stop()
        records = [json.loads(line) for line in open(log)]
        assert len(records) == 3
        assert sum(r["frames"] for r in records) == 6
        assert all(len(r["slots"]) == 2 for r in records)


class TestPodPerSlotParams:
    def test_stereo_width_per_slot(self):
        cfg = AuralizerConfig(channels=2)
        params = [LiveParams(), LiveParams(stereo_width=0.0)]
        clip = clips(1, 4)[0]
        p = run(pod(cfg, 2, params=params), [clip, clip.copy()])
        wide = p.pull(0, 4 * HOP * 2).reshape(-1, 2)
        mono = p.pull(1, 4 * HOP * 2).reshape(-1, 2)
        assert np.any(mono != 0.0)
        np.testing.assert_array_equal(mono[:, 0], mono[:, 1])
        assert not np.allclose(wide[:, 0], wide[:, 1], atol=1e-6)
        p.stop()

    def test_param_field_mismatch_fails_loudly(self):
        params = [LiveParams(pan_angles=np.linspace(0, np.pi / 2, 16)),
                  LiveParams()]
        clip = clips(1, 2)[0]
        p = pod(n_streams=2, params=params)
        p.start([iter(clip), iter(clip.copy())])
        t0 = time.monotonic()
        while p.is_running:
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="pod producer failed"):
            p.raise_if_failed()
        p.stop()

    def test_shared_params_object_grows_shared(self):
        shared = LiveParams()
        p = pod(n_streams=2, params=shared)
        p.resize(3)
        assert all(q is shared for q in p.params)
        with pytest.raises(ValueError, match="params sequence length"):
            pod(n_streams=2, params=[LiveParams()])


class TestOrthoModesPod:
    def test_pod_slots_match_offline(self):
        a, b = clips(2, 6, seed=100)
        p = run(ortho_pod(2), [a, b])
        for src, slot in ((a, 0), (b, 1)):
            np.testing.assert_array_equal(p.pull(slot, 6 * HOP),
                                          ortho_offline(src, p.cfg, 1))
        p.stop()

    def test_chunked_pod_matches_offline(self):
        a, b = clips(2, 6, seed=100)
        p = run(ortho_pod(2, chunk_frames=3), [a, b])
        assert p.metrics.dispatches == 2
        np.testing.assert_array_equal(p.pull(0, 6 * HOP),
                                      ortho_offline(a, p.cfg, 3))
        p.stop()

    def test_pod_checkpoint_engine_aware(self, tmp_path):
        p = run(ortho_pod(2), clips(2, 4))
        path = str(tmp_path / "pod.npz")
        p.save_state(path)
        p.load_state(path)
        p.stop()
        with pytest.raises(ValueError, match="OrthoCarry"):
            pod(n_streams=2).load_state(path)
        with pytest.raises(ValueError, match="pod size"):
            ortho_pod(3).load_state(path)

    def test_restored_carry_checked_against_the_first_tick(self, tmp_path):
        """A pod checkpoint of 64x64 frames restored into a pod fed 32x32
        frames fails at the first tick with the oscillator count."""
        p = run(ortho_pod(2), clips(2, 2))
        path = str(tmp_path / "pod.npz")
        p.save_state(path)
        p.stop()
        q = ortho_pod(2)
        q.load_state(path)
        q.start([iter(c) for c in clips(2, 2, size=32)])
        t0 = time.monotonic()
        while q.is_running:
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.005)
        with pytest.raises(RuntimeError) as e:
            q.raise_if_failed()
        assert "oscillators" in str(e.value.__cause__)
        q.stop()

    def test_stop_resets_the_tails(self):
        p = run(ortho_pod(2), clips(2, 2))
        assert p.snapshot_carry().ola_tail.any()
        p.stop()
        assert not p.snapshot_carry().ola_tail.any()
