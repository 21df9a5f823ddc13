"""The port's flagship model handle (vaudio_torch.models.AuralizerModel)
against the JAX package's vaudio.models.AuralizerModel on the CPU, at a
small frame size: the state factory and the default params exactly, the
step on its example inputs and a few structured frames within the main
path's band (PCM 2e-5, hues and phases exact)."""

import numpy as np
import pytest
import torch

import vaudio.models as jax_models
from torch_frames import structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.models import AuralizerModel
from vaudio_torch.runtime import step

PCM_ATOL = 2e-5          # the main path's band against the JAX package
H, W = 192, 256


def models(channels, debug=False):
    return (jax_models.AuralizerModel(JaxConfig(channels=channels),
                                      debug=debug),
            AuralizerModel(AuralizerConfig(channels=channels), debug=debug,
                           device="cpu"))


@pytest.mark.parametrize("channels", [1, 2])
def test_state_and_params_match_jax(channels):
    """init_state and default_params equal the JAX model's, field by field
    (values, dtypes and shapes); the state lies on the model's device."""
    jm, tm = models(channels)
    got, ref = step.carry_to_numpy(tm.init_state()), jm.init_state()
    for name in step.StepCarry._fields:
        want = np.asarray(getattr(ref, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert all(x.device.type == "cpu" for x in tm.init_state())
    gp, rp = tm.default_params(), jm.default_params()
    assert gp.keys() == rp.keys()
    for k in rp:
        assert np.asarray(gp[k]).dtype == np.asarray(rp[k]).dtype, k
        assert gp[k] == rp[k], k


@pytest.mark.parametrize("channels", [1, 2])
def test_step_on_example_inputs_matches_jax(channels):
    """The example inputs (the fresh state, a zero f32 frame, the default
    params), then three structured frames, through the model's step,
    __call__ and eager_step, chained, against the JAX model's step: PCM
    within 2e-5, hues and phases exact, the rest of the carry within
    2e-5."""
    jm, tm = models(channels, debug=True)
    tc, tframe, tparams = tm.example_inputs(H, W)
    jc, jframe, jparams = jm.example_inputs(H, W)
    assert tframe.shape == (H, W, 3) and tframe.dtype == torch.float32
    assert tframe.device.type == "cpu" and not bool(tframe.any())
    frames = [np.array(jframe)] + list(structured_frames(3, 3, H, W))
    calls = [tm.step, tm, tm.eager_step, tm.step]
    for call, frame in zip(calls, frames):
        jc, jout = jm.step(jc, frame, jparams)
        tc, tout = call(tc, frame, tparams)
        np.testing.assert_allclose(tout["pcm"].numpy(),
                                   np.asarray(jout["pcm"]), rtol=0,
                                   atol=PCM_ATOL)
        np.testing.assert_array_equal(tout["hues"].numpy(),
                                      np.asarray(jout["hues"]))
        got = step.carry_to_numpy(tc)
        for name in ("hues", "phases"):
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(jc, name)),
                                          err_msg=name)
        for name in ("prev_spectrum", "ola_tail", "running_max"):
            np.testing.assert_allclose(got[name],
                                       np.asarray(getattr(jc, name)),
                                       rtol=0, atol=PCM_ATOL, err_msg=name)
    assert float(np.abs(np.asarray(jout["pcm"])).max()) > 0.01


def test_model_without_a_card_raises(monkeypatch):
    """The model runs on the card unless the CPU is asked for: without a
    card and without device="cpu" it raises the port's error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        AuralizerModel(AuralizerConfig())
