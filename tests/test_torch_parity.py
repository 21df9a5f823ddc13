"""vaudio_torch.utils.parity and the ``parity`` command: the port's copy of
the literal f64 reference pipeline against the JAX harness's
(``benchmarks/parity.py``), the port held to it through both runners
beside the JAX package's own errors, the gate's teeth, the command, and
the device audit on the CPU.

One frame of the literal oracle costs ~20 s of one CPU core whatever its
size (the spectrum's ~1M scalar partial evaluations), so the oracle runs
once per implementation on the harness's input and every test reuses
it."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.config import LiveParams as JaxParams
from vaudio.runtime import run_offline as jax_run_offline
from vaudio.runtime import run_offline_batched as jax_run_offline_batched
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.utils import parity

ROOT = Path(__file__).resolve().parents[1]
N, SIZE = 2, 64


def harness_frames(n=N, size=SIZE):
    """The JAX harness's own input (benchmarks/parity.py:90-92)."""
    return np.random.default_rng(0).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def oracle():
    """Both packages' reference pipelines on the harness's input."""
    spec = importlib.util.spec_from_file_location(
        "jax_parity_harness", ROOT / "benchmarks" / "parity.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    frames = harness_frames().astype(np.float64)
    return {"jax": harness.reference_pipeline(frames, JaxConfig()),
            "port": parity.reference_pipeline(frames, AuralizerConfig())}


def test_reference_pipeline_equals_the_jax_harness_bit_for_bit(oracle):
    """PCM, hues, grads and spectra of the port's copy equal the JAX
    harness's, bit for bit, over 2 frames (the carries included)."""
    for got, ref in zip(oracle["port"], oracle["jax"]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def jax_errors(runner, reference):
    """The JAX package's own max |err| against the oracle, per runner."""
    run = {"frame": jax_run_offline,
           "chunked": jax_run_offline_batched}[runner]
    audio, _, dbg = run(harness_frames(), JaxConfig(),
                        JaxParams().as_arrays(), debug=True)
    ref_pcm, _, _, ref_spec = reference
    spec = np.asarray(dbg["spectrum"])
    return {"spectrum": np.abs(spec[..., 0] + 1j * spec[..., 1]
                               - ref_spec).max(),
            "pcm": np.abs(np.asarray(audio) - ref_pcm).max()}


@pytest.mark.parametrize("runner", ["frame", "chunked"])
def test_run_parity_passes_within_the_jax_errors(oracle, runner):
    """Hues equal and every error under the harness's gates; the spectrum
    and PCM errors within the JAX package's own on the same input plus
    2e-5 (the port is within 2e-5 of the JAX package)."""
    rep = parity.run_parity(harness_frames(), AuralizerConfig(), "cpu",
                            runner=runner, reference=oracle["port"])
    assert rep["ok"] and rep["hues_identical"], rep
    assert rep["runner"] == runner and rep["device"] == "cpu"
    assert rep["gates"] == {"grads": 5e-3, "spectrum": 1e-3, "pcm": 1e-2}
    assert rep["bands"] == {"spectrum": 3.4e-5, "pcm": 3e-3}
    jax_err = jax_errors(runner, oracle["jax"])
    for k in ("spectrum", "pcm"):
        assert rep["max_abs_err"][k] <= jax_err[k] + 2e-5, (k, rep, jax_err)


def _perturbed(monkeypatch, what):
    real = parity.RUNNERS["frame"]

    def runner(*args, **kw):
        audio, carry, dbg = real(*args, **kw)
        if what == "hues":
            dbg["hues"] = dbg["hues"] + 1          # one bin off
        else:
            audio = audio * 1.01
        return audio, carry, dbg

    monkeypatch.setitem(parity.RUNNERS, "frame", runner)


@pytest.mark.parametrize("what", ["hues", "pcm"])
def test_the_gate_has_teeth(oracle, monkeypatch, what):
    """A runner whose hues are one bin off, or whose PCM is 1% louder,
    fails the gate."""
    _perturbed(monkeypatch, what)
    rep = parity.run_parity(harness_frames(), AuralizerConfig(), "cpu",
                            reference=oracle["port"])
    assert not rep["ok"]
    if what == "hues":
        assert not rep["hues_identical"]
    else:
        assert rep["hues_identical"]
        assert rep["max_abs_err"]["pcm"] >= parity.GATES["pcm"]


def test_run_parity_is_mono_only():
    with pytest.raises(ValueError, match="mono"):
        parity.run_parity(harness_frames(1, 16), AuralizerConfig(channels=2),
                          "cpu", reference=())


def _cli(*args, **env):
    """``python -m vaudio_torch parity ARGS`` from the repository's root,
    VAUDIO_PLATFORM only as ``env`` gives it."""
    e = {k: v for k, v in os.environ.items() if k != "VAUDIO_PLATFORM"}
    e.update(env)
    e["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in e.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.run([sys.executable, "-m", "vaudio_torch", "parity",
                           *args], env=e, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_parity_command_on_the_cpu():
    """``VAUDIO_PLATFORM=cpu python -m vaudio_torch parity`` prints the
    JAX harness's lines and PASS, exit 0."""
    out = _cli("--frames", str(N), "--size", str(SIZE),
               VAUDIO_PLATFORM="cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == f"parity: {N} frames of {SIZE}x{SIZE} ..."
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "hues identical", "grads max |err|", "spectrum max |err|",
        "pcm max |err|", "PARITY"]
    assert lines[1].split()[-1] == "True"
    assert lines[-1] == "PARITY: PASS"


def test_parity_command_without_a_card_exits_1():
    """Without a card and without VAUDIO_PLATFORM the command names the
    card it needs and exits 1; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    out = _cli("--frames", "1", "--size", "16")
    assert out.returncode == 1
    assert "NVIDIA GPU" in out.stderr and "PARITY" not in out.stdout


def test_audit_stages_on_the_cpu():
    """Every stage of the device audit within its tolerance on the CPU
    (the kernels' plain versions), each with an error and a tolerance."""
    rep = parity.audit_stages("cpu", res="128x256")
    assert rep["device"] == "cpu"
    assert list(rep["stages"]) == [
        "mip_k1", "mip_f32_path", "mip_planes_k1", "histogram_k3",
        "acos_poly_dense_grid", "hsi_hue_poly_vs_exact", "contraction_k2",
        "phase_serial_vs_f64", "phase_cumsum_vs_f64",
        "phase_cumsum_vs_serial", "phase_cumsum_over_serial_ratio",
        "agc_ola_k4", "irfft_dense_matmul", "spectrum_ema_matmul"]
    for name, st in rep["stages"].items():
        assert st["ok"] and st["max_abs_err"] <= st["tol"], (name, st)
    assert rep["ok"]


def test_audit_records_a_stage_that_raises(monkeypatch):
    """A stage that raises fails with its error recorded; the others
    still run."""
    def boom(*a, **k):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(parity.audio_kernel, "agc_overlap_add_chunk", boom)
    rep = parity.audit_stages("cpu", res="128x256")
    assert not rep["ok"]
    st = rep["stages"]["agc_ola_k4"]
    assert not st["ok"] and "no kernel" in st["error"]
    assert rep["stages"]["irfft_dense_matmul"]["ok"]
