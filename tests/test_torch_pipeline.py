"""The port's main path — vaudio_torch.runtime.chunked.run_offline_batched
and vaudio_torch.api.Auralizer.sonify — and its per-frame twin against the
JAX package, on structured u8 clips (tests/torch_frames.py), with and
without the kernel paths K3 (use_pallas_vision) and K4 (use_pallas,
use_pallas_audio), plus the carry conversions and the port's guards."""

import dataclasses
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
    (dict(use_pallas=True), 64, 128, (0, 4, 0, 0)),
    (dict(use_pallas_audio=True), 64, 128, (0, 4, 0, 0)),
    (dict(use_pallas_vision=True), 64, 128, (4, 0, 2, 0)),
    (dict(use_pallas_vision=True), 64, 64, (0, 0, 0, 0)),   # wm % 16 != 0
    ({}, 64, 128, (0, 0, 0, 0)),
])
def test_kernel_flags_route_through_the_wrappers(monkeypatch, flags, H, W,
                                                 expect):
    """The flags send the per-frame step (4 frames) and the chunked pass A
    (chunks of 2) through the K3 and K4 wrappers, exactly where the JAX
    package calls its kernels: K3 in frame_stats for the shapes
    ``supports`` takes, K4 in the per-frame audio tail only.  Counted as
    (K3 per frame, K4 per frame, K3 chunked, K4 chunked)."""
    from vaudio_torch.ops import audio_kernel, vision_kernel
    calls = {"k3": 0, "k4": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(vision_kernel, "vision_stats",
                        counting("k3", vision_kernel.vision_stats))
    monkeypatch.setattr(step, "agc_overlap_add",
                        counting("k4", audio_kernel.agc_overlap_add))
    cfg = AuralizerConfig(**flags)
    frames = structured_frames(10, 4, H, W)
    step.run_offline(frames, cfg, device="cpu")
    per_frame = (calls["k3"], calls["k4"])
    calls.update(k3=0, k4=0)
    chunked.run_offline_batched(frames, cfg, chunk=2, device="cpu")
    assert per_frame + (calls["k3"], calls["k4"]) == expect


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
    back = step.carry_from_numpy(step.carry_to_numpy(carry))
    for name in step.StepCarry._fields:
        a, b = getattr(carry, name), getattr(back, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    fresh = step.init_carry(cfg)
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
        carry=step.carry_from_numpy(saved), device="cpu")
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    assert_carries_agree(c_got, c_ref)


def test_import_and_slice_leave_jax_out():
    """vaudio_torch imports neither jax nor the JAX package: checked in a
    fresh interpreter after the offline slice and a short stream with both
    kernel paths on, with TF32 off."""
    code = textwrap.dedent("""
        import sys
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
        aur = Auralizer(source=frames[:4], config=cfg, device="cpu")
        aur.run_until_exhausted(timeout=60)
        assert aur.metrics["frames_processed"] == 4
        assert aur.pull(4 * 2048 * 2).shape == (4 * 2048 * 2,)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "vaudio")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tf32_is_off_after_import():
    import vaudio_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("flag", [
    "use_phase_lut", "use_matmul_irfft", "use_matmul_ema", "quantize_mips",
    "quantize_mips_int8",
])
def test_flags_outside_the_slice_raise(flag):
    cfg = dataclasses.replace(AuralizerConfig(), **{flag: True})
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Auralizer(config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chunked.run_offline_batched(frames, cfg, device="cpu")


def test_inputs_outside_the_slice_raise():
    cfg = AuralizerConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Auralizer(config=dataclasses.replace(cfg, linear_cell_grads=False))
    yuv = {"y": np.zeros((2, 32, 32), np.uint8),
           "u": np.zeros((2, 16, 16), np.uint8),
           "v": np.zeros((2, 16, 16), np.uint8)}
    with pytest.raises(NotImplementedError, match="YUV"):
        Auralizer(config=cfg, device="cpu").sonify(yuv)
    from vaudio_torch.vision import features
    with pytest.raises(NotImplementedError, match="debug"):
        features.frame_stats(torch.zeros((1, 32, 32, 3)), cfg,
                             compute_debug_maps=True)
    with pytest.raises(ValueError, match="sonify mode"):
        Auralizer(config=cfg, device="cpu").sonify(
            np.zeros((2, 32, 32, 3)), mode="stream")
