"""The port's ``entry()`` (vaudio_torch.entry, the counterpart of the JAX
package's ``__graft_entry__.entry``) and its examples
(vaudio_torch.examples) on the CPU.

``entry(device="cpu")``'s step against JAX ``entry()``'s on the same inputs
(its 1080p black frame, then structured frames): PCM within 2e-5, hues
equal; against ``frame_step`` called directly, bit for bit.  The examples:
config 1 and 4's WAVs, config 5 over repeated CPU devices against the
one-device run, and the walkthrough and serving-pod scripts end to end."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
from torch_frames import structured_frames
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.entry import entry
from vaudio_torch.examples import baseline_configs, serving_pod, walkthrough
from vaudio_torch.io import read_wav
from vaudio_torch.runtime import step

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__ as jax_entry  # noqa: E402

PCM_ATOL = 2e-5


def test_entry_matches_jax_entry():
    fn, (carry, frame, params) = entry(device="cpu")
    assert frame.shape == (1080, 1920, 3) and frame.device.type == "cpu"
    jfn, (jcarry, jframe, jparams) = jax_entry.entry()
    jfn = jax.jit(jfn)
    frames = [frame] + [torch.as_tensor(f) for f in
                        structured_frames(80, 2, 192, 256)]
    for k, f in enumerate(frames):
        carry, out = fn(carry, f, params)
        jcarry, jout = jfn(jcarry, jframe if k == 0 else
                           np.asarray(f.numpy()), jparams)
        pcm = out["pcm"]
        assert pcm.dtype == torch.float32 and pcm.shape == (2048,)
        assert torch.isfinite(pcm).all()
        np.testing.assert_allclose(pcm.numpy(), np.asarray(jout["pcm"]),
                                   atol=PCM_ATOL)
        np.testing.assert_array_equal(carry.hues.numpy(),
                                      np.asarray(jcarry.hues))
    assert np.abs(np.asarray(jout["pcm"])).max() > 1e-3


def test_entry_equals_frame_step():
    """``fn`` is frame_step with the constants built once: the same bits
    as the model's own step, and it leaves its carry untouched."""
    fn, (carry, _, params) = entry(device="cpu")
    f = torch.as_tensor(structured_frames(81, 1, 64, 64)[0])
    before = carry.phases.clone()
    c1, out = fn(carry, f, params)
    c2, ref = step.make_step(AuralizerConfig(), device="cpu")(carry, f,
                                                               params)
    torch.testing.assert_close(out["pcm"], ref["pcm"], rtol=0, atol=0)
    torch.testing.assert_close(c1.ola_tail, c2.ola_tail, rtol=0, atol=0)
    assert torch.equal(carry.phases, before)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()


def test_config1_small_frame(tmp_path):
    baseline_configs.config1_small_frame(str(tmp_path), device="cpu")
    audio, sr = read_wav(str(tmp_path / "config1.wav"))
    assert audio.shape == (30 * 2048,) and sr == 44100


def test_config4_live_stream(tmp_path):
    baseline_configs.config4_live_stream(str(tmp_path), device="cpu")
    audio, sr = read_wav(str(tmp_path / "config4.wav"))
    # The ring holds the last ring_buffer_frames hops (16): the rest of
    # the 60 frames dropped on full, as in the JAX example.
    assert sr == 48000 and audio.shape == (16 * 2048, 2)


def test_config5_mesh_batch_on_repeated_cpu_devices():
    """8 streams over a (4, 2) mesh of one CPU device repeated, against
    each stream's one-device run (the TP cell sum: within 2e-5)."""
    audio = baseline_configs.config5_mesh_batch(device="cpu", n_frames=2,
                                                size=(64, 64))
    assert audio.shape == (8, 2 * 2048)
    frames = np.random.default_rng(5).uniform(
        0, 1, (8, 2, 64, 64, 3)).astype(np.float32)
    for s in range(8):
        ref, _, _ = step.run_offline(frames[s], AuralizerConfig(),
                                     device="cpu")
        np.testing.assert_allclose(audio[s], ref.numpy(), atol=PCM_ATOL)


def test_walkthrough(tmp_path, capsys):
    walkthrough.main(str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "walkthrough complete" in out
    assert {"green.wav", "state.npz", "stereo_filtered.wav", "debug"} <= \
        set(os.listdir(tmp_path))


def test_serving_pod_example(capsys):
    m = serving_pod.main(device="cpu")
    assert m["frames_processed"] >= 160
    assert "[done]" in capsys.readouterr().out
