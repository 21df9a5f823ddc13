"""The plain reference at tiny sizes: against itself, against the program
on the CPU under both phase definitions, and apart from its TF32 control."""

import dataclasses

import numpy as np
import pytest
import torch

from vbench import manifest as mf
from vbench.frames import FramePool
from vbench.reference.flagship import (FlagshipReference, snap_index,
                                       tf32_round)

CONFIG = mf.config(mf.load(), "flagship-1080p")
T = 24


@pytest.fixture(scope="module")
def pool():
    return FramePool(2 ** 31 + 99, T, 160, 320, 3, 4, 360, "cpu")


def _ref(pool, phase_sum="frame", matmul="float32", block=16,
         device="cpu"):
    ref = FlagshipReference(CONFIG["auralizer"], CONFIG["live_params"],
                            device, phase_sum=phase_sum, matmul=matmul)
    return ref.run(lambda a, b: pool.on_device(range(a, b)).to(device), T,
                   block=block).cpu().numpy()


def test_blocks_do_not_matter(pool):
    """Any block size gives the same PCM bit for bit: the serial state is
    carried across blocks whole."""
    a = _ref(pool, block=16)
    assert a.shape == (T, 2048, 2) and np.isfinite(a).all()
    assert np.array_equal(a, _ref(pool, block=5))


@pytest.fixture(scope="module")
def program(pool):
    from vaudio_torch.config import AuralizerConfig, LiveParams
    from vaudio_torch.runtime.chunked import run_offline_batched
    from vaudio_torch.runtime.step import run_offline
    cfg = AuralizerConfig(**CONFIG["auralizer"])
    params = LiveParams(**CONFIG["live_params"]).as_arrays()
    host = pool.to_host()
    return {name: run(host, cfg, params, device="cpu")[0].numpy()
            .reshape(T, 2048, 2)
            for name, run in (("frame", run_offline),
                              ("advances", run_offline_batched))}


@pytest.mark.parametrize("phase_sum", ["frame", "advances"])
def test_program_within_limit_control_beyond(pool, program, phase_sum):
    """The program's per-frame step agrees with the ``frame`` phases and
    its chunked path with the ``advances`` phases, far inside the cells'
    limits; the TF32 control lies beyond them."""
    ref = _ref(pool, phase_sum)
    sound = np.abs(program[phase_sum] - ref).max()
    control = np.abs(_ref(pool, phase_sum, matmul="tf32") - ref).max()
    limits = [mf.limits(w["name"])["pcm_gap"]
              for w in mf.load()["workloads"]]
    assert sound < min(limits) / 3
    assert control > max(limits)
    assert control > 10 * sound


def test_phase_definitions_differ(pool):
    """The two phase definitions are not the same numbers (the reason the
    traffic names one)."""
    assert not np.array_equal(_ref(pool, "frame"), _ref(pool, "advances"))


def test_f0_snap_has_room():
    """No hue's f0 lies within float32 reach of a midpoint between two
    bins, so the snap is the same in any precision."""
    ref = FlagshipReference(CONFIG["auralizer"], CONFIG["live_params"],
                            "cpu")
    hue = np.arange(361, dtype=np.float64)
    exact = 220.0 * 2.0 ** (hue / 360.0 * 3.0)
    f32 = (np.float32(220.0) * np.exp2(hue.astype(np.float32)
                                       / np.float32(360.0)
                                       * np.float32(3.0))).astype(np.float32)
    for e, f in zip(exact, f32):
        assert snap_index(ref.freqs, e) == snap_index(ref.freqs,
                                                      float(f))
        i = snap_index(ref.freqs, e)
        lo = abs(ref.freqs[i] - e)
        nb = [abs(ref.freqs[j] - e) for j in (i - 1, i + 1)
              if 0 <= j < len(ref.freqs)]
        assert min(nb) - lo > 1e-3


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.14159265, 1e-30])
    y = tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0                  # tie to even
    assert y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) + 3.14159265) < 2 ** -9
    bits = y.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_rejects_what_it_does_not_implement():
    a = dict(CONFIG["auralizer"], quantize_mips=True)
    with pytest.raises(ValueError):
        FlagshipReference(a, CONFIG["live_params"], "cpu")


@pytest.mark.cuda
def test_control_on_the_card(pool, card):
    """On the card the control is the tensor cores' TF32: beyond every
    cell's limit, while the float32 reference there agrees with the CPU's
    to far inside it."""
    dev = _ref(pool, device=card)
    host = _ref(pool)
    control = _ref(pool, matmul="tf32", device=card)
    limits = [mf.limits(w["name"])["pcm_gap"]
              for w in mf.load()["workloads"]]
    assert np.abs(dev - host).max() < min(limits) / 3
    assert np.abs(control - dev).max() > max(limits)
