"""The port's main path — vaudio_torch.runtime.chunked.run_offline_batched
and vaudio_torch.api.Auralizer.sonify — and its per-frame twin against the
JAX package, on structured u8 clips (tests/torch_frames.py), with and
without the kernel paths K3 (use_pallas_vision) and K4 (use_pallas,
use_pallas_audio), plus the carry conversions and the port's guards."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import vaudio.runtime.chunked as jax_chunked
import vaudio.runtime.step as jax_step
import vaudio.vision.features as jax_features
from torch_frames import structured_frames
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.api import Auralizer
from vaudio_torch.runtime import chunked, step

PARAMS = LiveParams().as_arrays()
# The chunked band of tests/test_chunked.py:20; measured ~3e-6 here.
PCM_ATOL = 2e-5


def assert_carries_agree(got, ref, atol=PCM_ATOL):
    got = step.carry_to_numpy(got)
    np.testing.assert_array_equal(got["hues"], np.asarray(ref.hues))
    np.testing.assert_array_equal(got["phases"], np.asarray(ref.phases))
    for name in ("prev_spectrum", "ola_tail"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got["running_max"],
                               np.asarray(ref.running_max), rtol=1e-6)


@pytest.mark.parametrize("H,W,channels,cumsum", [
    (192, 256, 1, False), (192, 256, 1, True), (192, 256, 2, False),
    (192, 256, 2, True),
    (192, 192, 2, True),          # mip 24x24: the generic gradient path
])
def test_chunked_matches_jax(H, W, channels, cumsum):
    """T=12 with chunk 8 (one ragged chunk of 4).  Hue sequences exact;
    phases bit-exact on both phase paths (the serial one through the FMA
    of phase_accumulate, the prefix sum through jax.lax.associative_scan's
    combine order), so the PARITY band for cumsum phases is not needed and
    the PCM is held to the serial 2e-5 in both."""
    cfg = AuralizerConfig(channels=channels, use_cumsum_phases=cumsum)
    frames = structured_frames(0, 12, H, W)
    a_ref, c_ref, d_ref = jax_chunked.run_offline_batched(
        frames, cfg, dict(PARAMS), chunk=8, debug=True)
    a_got, c_got, d_got = chunked.run_offline_batched(
        frames, cfg, dict(PARAMS), chunk=8, debug=True, device="cpu")
    hues = d_got["hues"].numpy()
    np.testing.assert_array_equal(hues, np.asarray(d_ref["hues"]))
    assert len(np.unique(hues)) > 50            # the hues really moved
    assert a_got.shape == np.asarray(a_ref).shape
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    np.testing.assert_allclose(d_got["grads"].numpy(),
                               np.asarray(d_ref["grads"]), atol=1e-6)
    np.testing.assert_allclose(d_got["spectrum"].numpy(),
                               np.asarray(d_ref["spectrum"]), atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


def test_auralizer_sonify_matches_jax_chunked():
    """The entry point: stereo at 48 kHz, the default chunk of 64."""
    cfg = AuralizerConfig(sample_rate=48000.0, channels=2)
    frames = structured_frames(1, 12, 192, 256)
    ref, _, _ = jax_chunked.run_offline_batched(frames, cfg, dict(PARAMS))
    got = Auralizer(config=cfg, device="cpu").sonify(frames)
    assert isinstance(got, np.ndarray) and got.shape == (12 * 2048, 2)
    np.testing.assert_allclose(got, np.asarray(ref), atol=PCM_ATOL)


@pytest.mark.parametrize("channels", [1, 2])
def test_per_frame_run_offline_matches_jax(channels):
    """frame_step in a Python loop against the JAX lax.scan: 2e-5."""
    cfg = AuralizerConfig(channels=channels)
    frames = structured_frames(2, 4, 192, 256)
    a_ref, c_ref, d_ref = jax_step.run_offline(frames, cfg, dict(PARAMS),
                                               debug=True)
    a_got, c_got, d_got = step.run_offline(frames, cfg, dict(PARAMS),
                                           debug=True, device="cpu")
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


@pytest.mark.parametrize("flag", ["use_pallas", "use_pallas_audio"])
@pytest.mark.parametrize("channels", [1, 2])
def test_per_frame_run_offline_with_k4_matches_jax(flag, channels):
    """The per-frame step with the fused AGC + overlap-add (K4; the JAX
    package runs its Pallas kernel in interpret mode on the CPU, and with
    use_pallas also its per-frame spectrum kernel): hues exact, PCM
    within 2e-5."""
    cfg = AuralizerConfig(channels=channels, **{flag: True})
    frames = structured_frames(7, 4, 192, 256)
    a_ref, c_ref, d_ref = jax_step.run_offline(frames, cfg, dict(PARAMS),
                                               debug=True)
    a_got, c_got, d_got = step.run_offline(frames, cfg, dict(PARAMS),
                                           debug=True, device="cpu")
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


@pytest.mark.parametrize("run,channels", [("chunked", 1), ("chunked", 2),
                                          ("scan", 2)])
def test_vision_kernel_path_matches_jax(monkeypatch, run, channels):
    """use_pallas_vision (K3) against the JAX package's vision kernel, run
    through its CPU interpret escape hatch as tests/test_pallas.py:289-302
    does (use_pallas_pool off there): hues exact, grads within 1e-6, PCM
    within 2e-5.  Chunked: T=12 in chunks of 8; scan: per frame."""
    monkeypatch.setattr(jax_features, "_PALLAS_POOL_ON_CPU", True)
    cfg = AuralizerConfig(channels=channels, use_pallas_vision=True,
                          use_pallas_pool=False)
    if run == "chunked":
        frames = structured_frames(8, 12, 192, 256)
        ref = jax_chunked.run_offline_batched(frames, cfg, dict(PARAMS),
                                              chunk=8, debug=True)
        got = chunked.run_offline_batched(frames, cfg, dict(PARAMS),
                                          chunk=8, debug=True, device="cpu")
    else:
        frames = structured_frames(9, 4, 192, 256)
        ref = jax_step.run_offline(frames, cfg, dict(PARAMS), debug=True)
        got = step.run_offline(frames, cfg, dict(PARAMS), debug=True,
                               device="cpu")
    (a_ref, c_ref, d_ref), (a_got, c_got, d_got) = ref, got
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    np.testing.assert_allclose(d_got["grads"].numpy(),
                               np.asarray(d_ref["grads"]), atol=1e-6)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


@pytest.mark.parametrize("flags,H,W,expect", [
    (dict(use_pallas=True), 64, 128, (0, 4, 0, 2)),
    (dict(use_pallas_audio=True), 64, 128, (0, 4, 0, 2)),
    (dict(use_pallas_vision=True), 64, 128, (4, 0, 2, 2)),
    (dict(use_pallas_vision=True), 64, 64, (0, 0, 0, 2)),   # wm % 16 != 0
    ({}, 64, 128, (0, 0, 0, 2)),
])
def test_kernel_flags_route_through_the_wrappers(monkeypatch, flags, H, W,
                                                 expect):
    """The flags send the per-frame step (4 frames) and the chunked pass A
    (chunks of 2) through the K3 and K4 wrappers: K3 in frame_stats for the
    shapes ``supports`` takes, where the JAX package calls its kernel; K4
    in the per-frame audio tail under the flags, as the JAX package, and
    once per chunk in the chunked audio tail whatever the flags (the JAX
    chunked tail has none).  Counted as (K3 per frame, K4 per frame, K3
    chunked, K4 chunked)."""
    from vaudio_torch.ops import audio_kernel, vision_kernel
    calls = {"k3": 0, "k4": 0, "k4c": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(vision_kernel, "vision_stats",
                        counting("k3", vision_kernel.vision_stats))
    monkeypatch.setattr(step, "agc_overlap_add",
                        counting("k4", audio_kernel.agc_overlap_add))
    monkeypatch.setattr(chunked, "agc_overlap_add_chunk",
                        counting("k4c", audio_kernel.agc_overlap_add_chunk))
    cfg = AuralizerConfig(**flags)
    frames = structured_frames(10, 4, H, W)
    step.run_offline(frames, cfg, device="cpu")
    per_frame = (calls["k3"], calls["k4"])
    assert calls["k4c"] == 0
    calls.update(k3=0, k4=0)
    chunked.run_offline_batched(frames, cfg, chunk=2, device="cpu")
    assert per_frame + (calls["k3"], calls["k4c"]) == expect
    assert calls["k4"] == 0


def test_blocked_run_offline_equals_chunked():
    """run_offline(block=4) is chunk_pipeline over 4-frame blocks plus a
    remainder: equal to run_offline_batched with chunk 4."""
    cfg = AuralizerConfig()
    frames = structured_frames(4, 10, 192, 256)
    a_blk, c_blk, _ = step.run_offline(frames, cfg, block=4, device="cpu")
    a_chk, c_chk, _ = chunked.run_offline_batched(frames, cfg, chunk=4,
                                                  device="cpu")
    np.testing.assert_array_equal(a_blk.numpy(), a_chk.numpy())
    np.testing.assert_array_equal(c_blk.hues.numpy(), c_chk.hues.numpy())


def test_carry_round_trip():
    cfg = AuralizerConfig(channels=2)
    _, carry, _ = chunked.run_offline_batched(
        structured_frames(5, 3, 64, 64), cfg, device="cpu")
    back = step.carry_from_numpy(step.carry_to_numpy(carry), "cpu")
    for name in step.StepCarry._fields:
        a, b = getattr(carry, name), getattr(back, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    fresh = step.init_carry(cfg, "cpu")
    ref = jax_step.init_carry(cfg)
    for name in step.StepCarry._fields:
        assert step.carry_to_numpy(fresh)[name].shape == \
            np.asarray(getattr(ref, name)).shape, name


def test_jax_carry_resumes_in_the_port():
    """A carry saved by JAX after 8 frames continues in the port; the
    continued PCM matches JAX continuing from the same carry: 2e-5."""
    cfg = AuralizerConfig(channels=2)
    frames = structured_frames(6, 12, 192, 256)
    _, c8, _ = jax_chunked.run_offline_batched(frames[:8], cfg, dict(PARAMS),
                                               chunk=8)
    saved = {k: np.asarray(v) for k, v in c8._asdict().items()}
    a_ref, c_ref, _ = jax_chunked.run_offline_batched(
        frames[8:], cfg, dict(PARAMS), carry=jax_step.StepCarry(**saved))
    a_got, c_got, _ = chunked.run_offline_batched(
        frames[8:], cfg, dict(PARAMS),
        carry=step.carry_from_numpy(saved, "cpu"), device="cpu")
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


def test_import_and_slice_leave_jax_out(tmp_path):
    """vaudio_torch imports neither jax nor the JAX package: checked in a
    fresh interpreter after the offline slice (RGB, a planar YUV dict and a
    debug run), a short stream with both kernel paths on, the OrthoModes
    family offline and streamed in chunks, the serving pod of both
    families in chunks with a checkpoint round trip, a pod served by its
    PodServer and driven by vaudio_torch.client, and the serving
    path: frames pushed over HTTP into a served PushSource stream (the C++
    ring), the control channel, the live debug surface, the debug views,
    a checkpoint over HTTP and the native frame reader, the multi-device
    paths of vaudio_torch.parallel (dryrun_multichip over a repeated CPU
    device), and the command line, the doctor, a profiler trace of
    entry()'s step and the examples' modules, every subpackage, and the
    ``parity`` command against the literal oracle on one frame; with TF32
    off."""
    code = textwrap.dedent("""
        import sys
        import time
        import numpy as np
        import torch
        from vaudio_torch.config import AuralizerConfig
        from vaudio_torch.api import Auralizer
        frames = np.zeros((8, 32, 32, 3), np.uint8)
        frames[:, :, :16] = (200, 40, 40)
        cfg = AuralizerConfig(channels=2, use_pallas=True,
                              use_pallas_vision=True)
        audio = Auralizer(config=cfg, device="cpu").sonify(frames)
        assert audio.shape == (8 * 2048, 2)
        yuv = {"y": np.full((8, 32, 32), 120, np.uint8),
               "u": np.full((8, 16, 16), 90, np.uint8),
               "v": np.full((8, 16, 16), 200, np.uint8)}
        assert Auralizer(config=cfg, device="cpu").sonify(yuv).shape == (
            8 * 2048, 2)
        pcm, dbg = Auralizer(config=cfg, device="cpu").sonify(frames,
                                                              debug=True)
        assert dbg["spectrum"].shape == (8, 2, 2047, 2)
        aur = Auralizer(source=frames[:4], config=cfg, device="cpu")
        aur.run_until_exhausted(timeout=60)
        assert aur.metrics["frames_processed"] == 4
        assert aur.pull(4 * 2048 * 2).shape == (4 * 2048 * 2,)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        ortho = Auralizer(config=cfg, model="orthomodes", device="cpu")
        assert ortho.sonify(frames).shape == (8 * 2048,)
        aur = Auralizer(source=frames[:4], config=cfg, model="orthomodes",
                        device="cpu", chunk_frames=2)
        aur.run_until_exhausted(timeout=60)
        assert aur.pull(4 * 2048).shape == (4 * 2048,)
        from vaudio_torch.runtime import MultiStreamAuralizer
        from vaudio_torch.runtime.engine import make_engine
        for model in ("auralizer", "orthomodes"):
            eng = make_engine(model, cfg, device="cpu")
            pod = MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                       chunk_frames=2)
            pod.start([frames[:4], frames[4:7]])
            t0 = time.monotonic()
            while pod.is_running and time.monotonic() - t0 < 60:
                time.sleep(0.01)
            pod.raise_if_failed()
            assert pod.metrics.frames_processed == 7
            pod.save_state(sys.argv[1] + "/pod.npz")
            pod.load_state(sys.argv[1] + "/pod.npz")
            pod.stop()
        from vaudio_torch.client import PodClient, frame_sig_json
        eng = make_engine("auralizer", cfg, device="cpu")
        pod = MultiStreamAuralizer(cfg, n_streams=1, engine=eng,
                                   exit_when_exhausted=False)
        panel = pod.serve(port=0)
        try:
            pod.start([iter(())])
            client = PodClient(panel.url)
            slot = client.acquire(when_empty="dark")
            for fr in frames[:3]:
                slot.push(fr)
            t0 = time.monotonic()
            while (pod.metrics.frames_processed < 3
                   and time.monotonic() - t0 < 60):
                time.sleep(0.01)
            m = client.metrics()
            assert m["frame_sig"] == frame_sig_json(frames[0])
            assert slot.view("input").startswith(b"\\x89PNG")
            assert client.load_state(client.save_state())["restored"]
            slot.release()
        finally:
            panel.stop()
            pod.stop()

        import io, time, urllib.request
        from vaudio_torch.io import PushSource, RawVideoSource
        from vaudio_torch.io.push import push_frames
        from vaudio_torch.runtime.ringbuffer import NativeRingBuffer
        tmp = sys.argv[1]
        aur = Auralizer(source=PushSource(maxsize=4, when_empty="block"),
                        config=cfg, device="cpu", debug=True)
        channel = aur.attach_control(io.StringIO('{"attack": 0.5}\\n'))
        renderer = aur.live_debug(tmp + "/live", every_frames=1)
        server = aur.serve(port=0)
        try:
            aur.start()
            assert push_frames(server.url, None, frames[:4]) == 4
            t0 = time.monotonic()
            while aur.is_running and time.monotonic() - t0 < 60:
                time.sleep(0.01)
            assert aur.metrics["frames_processed"] == 4
            assert isinstance(aur._stream.ring, NativeRingBuffer)
            for path in ("metrics.prom", "debug/input.png",
                         "debug/spectrum.png", "state.npz"):
                with urllib.request.urlopen(server.url + path,
                                            timeout=30) as r:
                    assert r.status == 200
        finally:
            server.stop()
            renderer.stop()
            aur.stop()
        assert aur.params.attack == 0.5 and renderer.renders >= 1
        with open(tmp + "/clip.rgb", "wb") as f:
            f.write(frames.tobytes())
        got = list(RawVideoSource(tmp + "/clip.rgb", 32, 32, native=True,
                                  zero_copy=True).frames())
        assert len(got) == 8
        import contextlib
        from vaudio_torch.parallel.dryrun import dryrun_multichip
        with contextlib.redirect_stdout(io.StringIO()):
            assert len(dryrun_multichip(2, devices=["cpu"])) == 4
        import os
        import vaudio_torch.examples.baseline_configs
        import vaudio_torch.examples.serving_pod
        import vaudio_torch.examples.walkthrough
        from vaudio_torch import cli
        from vaudio_torch.entry import entry
        from vaudio_torch.utils import doctor, profiling
        os.environ["VAUDIO_PLATFORM"] = "cpu"
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["synthetic", "--frames", "2", "--width", "32",
                             "--height", "32", "-o", tmp + "/s.wav"]) == 0
            assert cli.main(["info"]) == 0
        import vaudio_torch.dsp, vaudio_torch.ops, vaudio_torch.runtime
        import vaudio_torch.synth, vaudio_torch.utils, vaudio_torch.vision
        import vaudio_torch.utils.parity
        with contextlib.redirect_stdout(io.StringIO()) as said:
            assert cli.main(["parity", "--frames", "1", "--size", "32"]) == 0
        assert said.getvalue().splitlines()[-1] == "PARITY: PASS"
        assert doctor.check_versions()["status"] == "ok"
        fn, (carry, frame, params) = entry(device="cpu")
        with profiling.trace_context(tmp + "/trace", device="cpu"):
            carry, out = fn(carry, frame, params)
        assert out["pcm"].shape == (2048,)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "vaudio")))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tf32_is_off_after_import():
    import vaudio_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# The flags the port once refused, each as the config that runs it
# (quantize_mips_int8 acts only with quantize_mips, as in the JAX package).
FLAG_CONFIGS = {
    "use_phase_lut": dict(use_phase_lut=True),
    "use_matmul_irfft": dict(use_matmul_irfft=True),
    "use_matmul_ema": dict(use_matmul_ema=True),
    "quantize_mips": dict(quantize_mips=True),
    "quantize_mips_int8": dict(quantize_mips=True, quantize_mips_int8=True),
    "linear_cell_grads": dict(linear_cell_grads=False),
}


@pytest.mark.parametrize("flag", list(FLAG_CONFIGS))
def test_flags_outside_the_slice_raise(flag):
    """Each flag once outside the slice now runs, and is held to the JAX
    package: the chunked path (T=12 in chunks of 8, stereo) and the
    per-frame path (T=4) give equal hues, phases bit for bit and PCM within
    2e-5."""
    cfg = AuralizerConfig(channels=2, **FLAG_CONFIGS[flag])
    Auralizer(config=cfg, device="cpu")
    frames = structured_frames(17, 12, 192, 256)
    for ref, got in (
            (jax_chunked.run_offline_batched(frames, cfg, dict(PARAMS),
                                             chunk=8, debug=True),
             chunked.run_offline_batched(frames, cfg, dict(PARAMS), chunk=8,
                                         debug=True, device="cpu")),
            (jax_step.run_offline(frames[:4], cfg, dict(PARAMS), debug=True),
             step.run_offline(frames[:4], cfg, dict(PARAMS), debug=True,
                              device="cpu"))):
        (a_ref, c_ref, d_ref), (a_got, c_got, d_got) = ref, got
        np.testing.assert_array_equal(d_got["hues"].numpy(),
                                      np.asarray(d_ref["hues"]))
        np.testing.assert_array_equal(c_got.phases.numpy(),
                                      np.asarray(c_ref.phases))
        np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                                   atol=PCM_ATOL)


def test_inputs_outside_the_slice_raise():
    """The orthomodes model, the last entry of the registry of unported
    features (_NOT_PORTED), is ported and the registry is gone; an unknown
    model family and an unknown sonify mode are ValueErrors."""
    import vaudio_torch
    cfg = AuralizerConfig()
    aur = Auralizer(config=cfg, device="cpu")
    assert not hasattr(vaudio_torch, "_NOT_PORTED")
    assert not hasattr(vaudio_torch, "not_ported")
    assert Auralizer(config=cfg, model="orthomodes",
                     device="cpu").model == "orthomodes"
    with pytest.raises(ValueError, match="unknown model family"):
        Auralizer(config=cfg, model="cells", device="cpu")
    with pytest.raises(ValueError, match="sonify mode"):
        aur.sonify(np.zeros((2, 32, 32, 3)), mode="stream")
