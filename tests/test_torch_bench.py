"""The port's headline benchmark (vaudio_torch.bench, ``python -m
vaudio_torch bench``) on the CPU, against the JAX package's ``bench.py``.

- The JSON line: ``bench.py`` and the port's bench run as processes at
  32x64 with chunks 2,4, one rep of one call; the port's keys are
  ``bench.py``'s plus the card's identity, under the same metric name.
- The timed callables (chunked, blocked, per frame) against the JAX
  package's ``chunk_pipeline``, ``blocked_pipeline`` and ``frame_step``
  scan, jitted as ``bench.py`` jits them, two chained calls: hues and
  phases equal, PCM and the carries' floats within 2e-5 (the port's band,
  tests/test_torch_pipeline.py).
- The slope statistics against a literal copy of ``bench.py``'s rep loop
  (bench.py:268-345), the floor, the kernel check and the device rule.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_frames import structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.dsp import hann_window_norm as jax_hann_window_norm
from vaudio.runtime import chunked as jax_chunked
from vaudio.runtime import step as jax_step
from vaudio.synth import SynthConstants as JaxSynthConstants
from vaudio_torch import bench, cli
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.runtime import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM_ATOL = 2e-5
TIMEOUT = 240
TINY = {"VAUDIO_BENCH_RES": "32x64", "VAUDIO_BENCH_CHUNKS": "2,4",
        "VAUDIO_BENCH_ITERS": "1", "VAUDIO_BENCH_SLOPE_REPS": "1",
        "VAUDIO_BENCH_MAX_REPS": "1"}
OPTIONAL_KEYS = {"fallback_upper_bound", "quantize_mips"}


def child_env(drop=(), **extra):
    """This process's environment less ``drop`` and every VAUDIO_BENCH_*
    variable, with ``extra`` and the repository first on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if k not in drop and not k.startswith("VAUDIO_BENCH_")}
    env.update(extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def last_json(stdout: str) -> dict:
    lines = stdout.strip().splitlines()
    assert lines, "no stdout"
    return json.loads(lines[-1])


def check_fallback_flag(rec: dict) -> None:
    """``fallback_upper_bound`` is there exactly when no slope was
    positive (bench.py:331-345, :367-368)."""
    assert ("fallback_upper_bound" in rec) == all(
        s <= 0 for s in rec["slopes_us"]), rec


# ---------------------------------------------------------------------------
# The JSON line, across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("settings", [
    {"VAUDIO_BENCH_SCAN": "0", "VAUDIO_BENCH_MONO": "0"},
    # Stereo, the scan path and mono, as by default; blocks of 2, since
    # bench.py's default blocks of 8 do not divide a chunk of 2.
    {"VAUDIO_BENCH_SCAN_BLOCK": "2"},
], ids=["stereo_only", "stereo_scan_mono"])
def test_json_line_has_bench_py_keys(tmp_path, settings):
    """Both benchmarks at the same tiny settings: the port's keys are
    ``bench.py``'s plus exactly the card's identity keys, the metric, unit
    and scan block equal; the port's floor is the card's at 32x64."""
    env = dict(TINY, **settings)
    ref = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        cwd=REPO, timeout=TIMEOUT,
        env=child_env(JAX_PLATFORMS="cpu", VAUDIO_JAX_CACHE=str(tmp_path),
                      **env))
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = subprocess.run(
        [sys.executable, "-m", "vaudio_torch", "bench"], capture_output=True,
        text=True, cwd=tmp_path, timeout=TIMEOUT,
        env=child_env(VAUDIO_PLATFORM="cpu", **env))
    assert got.returncode == 0, got.stderr[-3000:]
    ref_rec, rec = last_json(ref.stdout), last_json(got.stdout)
    for r in (ref_rec, rec):
        check_fallback_flag(r)
    extra = set(rec) - set(ref_rec) - OPTIONAL_KEYS
    assert extra == set(bench.IDENTITY_KEYS)
    assert set(ref_rec) - set(rec) - OPTIONAL_KEYS == set()
    for key in ("metric", "unit", "scan_block"):
        assert rec.get(key) == ref_rec.get(key), key
    for key, value in ref_rec.items():
        if key in rec and key != "slopes_us":
            assert type(rec[key]) is type(value), key
    assert rec["value"] > 0
    assert rec["static_floor_us"] == round(
        sum(bench.static_floor_us(32, 64, AuralizerConfig(channels=2))), 2)
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["torch"] == torch.__version__
    assert rec["cuda"] == torch.version.cuda
    assert isinstance(rec["nvcc"], bool)
    assert ("scan_path_x_realtime" in rec) == (settings.get(
        "VAUDIO_BENCH_SCAN") != "0")
    assert ("mono_x_realtime" in rec) == (settings.get(
        "VAUDIO_BENCH_MONO") != "0")
    assert "first call (incl. the kernels' load)" in got.stderr


def test_bench_imports_no_jax(tmp_path):
    """``python -m vaudio_torch.bench`` in a fresh interpreter on the CPU:
    exit 0, one JSON line last, and no jax, ``vaudio``, ``bench`` or
    ``benchmarks`` module loaded."""
    code = ("import json, runpy, sys\n"
            "sys.argv = ['vaudio_torch.bench']\n"
            "try:\n"
            "    runpy.run_module('vaudio_torch.bench', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vaudio', 'bench', 'benchmarks')]\n"
            "assert not bad, bad\n"
            "print(json.dumps({'modules': 'ok'}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=TIMEOUT,
                       env=child_env(VAUDIO_PLATFORM="cpu",
                                     VAUDIO_BENCH_SCAN="0",
                                     VAUDIO_BENCH_MONO="0", **TINY))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"modules": "ok"}
    assert json.loads(lines[-2])["metric"] == (
        "realtime_factor_1080p30_to_48kHz_stereo_per_chip")


@pytest.mark.parametrize("argv", [["-m", "vaudio_torch", "bench"],
                                  ["-m", "vaudio_torch.bench"]])
def test_no_card_exits_1_without_a_line(tmp_path, argv):
    """No card (CUDA_VISIBLE_DEVICES empty) and no VAUDIO_PLATFORM: exit 1
    with vaudio_torch.device()'s message, nothing on stdout."""
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, cwd=tmp_path, timeout=TIMEOUT,
                       env=child_env(drop=("VAUDIO_PLATFORM",),
                                     CUDA_VISIBLE_DEVICES="", **TINY))
    assert r.returncode == 1
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "VAUDIO_PLATFORM=cpu" in r.stderr
    assert r.stdout.strip() == ""


# ---------------------------------------------------------------------------
# The timed callables are the main path
# ---------------------------------------------------------------------------

def jax_runner(cfg, mode: str, scan_block: int):
    """bench.py's ``scan_chunk`` (bench.py:212-231) on the JAX package."""
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    consts = JaxSynthConstants.create(jcfg)
    window = jnp.asarray(jax_hann_window_norm(jcfg.nfft))
    params = jax_step.default_params(jcfg)
    if mode == "chunked":
        def run(carry, frames):
            return jax_chunked.chunk_pipeline(carry, frames, params, jcfg,
                                              consts, window)
    elif scan_block > 1:
        def run(carry, frames):
            return jax_chunked.blocked_pipeline(carry, frames, params, jcfg,
                                                consts, window,
                                                block=scan_block)
    else:
        def run(carry, frames):
            def body(c, f):
                return jax_step.frame_step(c, f, params, jcfg, consts,
                                           window)
            return jax.lax.scan(body, carry, frames, unroll=8)
    return jax.jit(run), jax_step.init_carry(jcfg)


@pytest.mark.parametrize("mode,scan_block,channels", [
    ("chunked", 8, 2), ("chunked", 8, 1), ("scan", 8, 2), ("scan", 4, 2),
    ("scan", 1, 2)])
def test_timed_callable_matches_jax(mode, scan_block, channels):
    """Two chained calls on 8 numpy-seeded u8 frames each: hues and phases
    equal, PCM, spectrum and tail within 2e-5.  The frames are hue blocks
    (``tests/torch_frames.py``) of 128x256, the least size at which every
    cell's mip passes the 20-pixel histogram gate, so the hues move (at
    32x64 they stay 0)."""
    cfg = AuralizerConfig(sample_rate=48000.0, channels=channels)
    clips = [structured_frames(seed, 8, 128, 256) for seed in (0, 1)]
    run = bench.make_runner(cfg, mode, scan_block, torch.device("cpu"))
    carry = step.init_carry(cfg, "cpu")
    jrun, jcarry = jax_runner(cfg, mode, scan_block)
    hue_seq = []
    for clip in clips:
        carry, out = run(carry, torch.as_tensor(clip))
        jcarry, jout = jrun(jcarry, jnp.asarray(clip))
        pcm, ref = out["pcm"].numpy(), np.asarray(jout["pcm"])
        assert np.abs(pcm).max() > 0
        assert pcm.shape == ref.shape == ((8, 2048, 2) if channels == 2
                                          else (8, 2048))
        np.testing.assert_allclose(pcm, ref, atol=PCM_ATOL)
        got = step.carry_to_numpy(carry)
        np.testing.assert_array_equal(got["hues"], np.asarray(jcarry.hues))
        np.testing.assert_array_equal(got["phases"],
                                      np.asarray(jcarry.phases))
        for name in ("prev_spectrum", "ola_tail"):
            np.testing.assert_allclose(got[name],
                                       np.asarray(getattr(jcarry, name)),
                                       atol=PCM_ATOL, err_msg=name)
        np.testing.assert_allclose(got["running_max"],
                                   np.asarray(jcarry.running_max), rtol=1e-6)
        hue_seq.append(got["hues"].copy())
    assert not np.array_equal(hue_seq[0], hue_seq[1])   # the carry moved


# ---------------------------------------------------------------------------
# The slope statistics, against bench.py's own loop
# ---------------------------------------------------------------------------

def bench_py_reps(seq, n_reps, max_reps):
    """bench.py:278-345 on scripted slopes: (slopes, stable, ms/frame or
    None for the upper-bound fallback)."""
    def mid3(ss):
        v = sorted(s for s in ss if s > 0)
        return v[(len(v) - 3) // 2:][:3] if len(v) >= 3 else v

    slopes, rep, stable = [], 0, False
    while True:
        slopes.append(seq[rep])
        rep += 1
        valid = sorted(s for s in slopes if s > 0)
        if rep >= n_reps and len(valid) >= 3:
            med = statistics.median(valid)
            mid = mid3(slopes)
            if (mid[-1] - mid[0]) <= 0.4 * med:
                stable = True
                break
        if rep >= max_reps:
            break
    valid = [s for s in slopes if s > 0]
    return slopes, stable, (statistics.median(mid3(slopes)) if valid
                            else None)


@pytest.mark.parametrize("seq,n_reps,max_reps,want_n,want_stable,want_ms", [
    ([1.0, 1.1, 1.2], 3, 8, 3, True, 1.1),            # stable at once
    ([1.0, 3.0, 1.0, 1.0], 3, 8, 4, True, 1.0),       # one extra rep
    ([1.0, 5.0] * 4, 3, 8, 8, False, 1.0),            # never agrees
    ([1.0, 1.0, 1.0, 2.0], 4, 8, 4, True, 1.0),       # SLOPE_REPS first
    ([-1.0, 0.0, -2.0], 3, 3, 3, False, None),        # the fallback
    ([-1.0], 1, 1, 1, False, None),
    ([2.0, -1.0, 1.0, 3.0, 100.0, 2.5], 3, 6, 6, True, 2.5),  # trimmed
    ([0.05, 1.0, 1.1, 1.05, 0.9], 3, 5, 5, True, 1.0),
])
def test_rep_loop_matches_bench_py(seq, n_reps, max_reps, want_n,
                                   want_stable, want_ms):
    """Middle three, the 40% gate, extra reps, the rep budget and the
    upper-bound fallback (no positive slope) on cases read off bench.py."""
    calls = []

    def slope_at(rep):
        calls.append(rep)
        return seq[rep]

    slopes, stable = bench.run_reps(slope_at, n_reps, max_reps)
    ms = bench.per_frame_ms(slopes)
    assert calls == list(range(want_n))
    assert (slopes, stable, ms) == bench_py_reps(seq, n_reps, max_reps)
    assert stable == want_stable
    assert ms == pytest.approx(want_ms) if want_ms is not None else ms is None


@pytest.mark.parametrize("seed", range(4))
def test_rep_loop_on_noisy_slopes(seed):
    """Random slopes, some negative, against bench.py's loop."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        seq = list(rng.normal(1.0, 0.6, 8))
        n_reps = int(rng.integers(1, 5))
        max_reps = int(rng.integers(n_reps, 9))
        slopes, stable = bench.run_reps(lambda r: seq[r], n_reps, max_reps)
        assert (slopes, stable, bench.per_frame_ms(slopes)) == \
            bench_py_reps(seq, n_reps, max_reps)


@pytest.mark.parametrize("slopes,want", [
    ([3.0, 1.0, 2.0], [1.0, 2.0, 3.0]),
    ([5.0, -1.0, 4.0, 3.0, 2.0, 1.0], [2.0, 3.0, 4.0]),
    ([1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0]),
    ([1.0, 2.0], [1.0, 2.0]),
    ([-1.0, 0.0], []),
])
def test_mid3(slopes, want):
    assert bench.mid3(slopes) == want


def test_fallback_record():
    """A fallback measurement keeps bench.py's flag in the record; a
    quantized config adds quantize_mips."""
    quality = {"slopes_us": [-3.0], "valid_reps": 0, "stable": False,
               "fallback_upper_bound": True}
    rec = bench.headline_record(40.0, 0.5, quality, 2, 1080, 1920, 3350.0)
    assert rec["fallback_upper_bound"] is True
    assert "quantize_mips" not in rec
    quality["fallback_upper_bound"] = False
    rec = bench.headline_record(40.0, 0.5, quality, 1, 1080, 1920, 3350.0)
    assert "fallback_upper_bound" not in rec
    assert rec["metric"] == "realtime_factor_1080p30_to_48kHz_per_chip"
    assert rec["us_per_frame"] == 500.0
    assert rec["ingest_hbm_gbs"] == round(1080 * 1920 * 3 / 500e3, 1)


# ---------------------------------------------------------------------------
# The floor, the kernel check, the identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels,k", [(2, 4), (1, 2)])
def test_static_floor(channels, k):
    """The u8 frame read at 3350 GB/s and K2's operations at 67 TFLOP/s:
    2047 bins x 496 partials x (27 + 2K)."""
    cfg = AuralizerConfig(sample_rate=48000.0, channels=channels)
    frame_us, spectrum_us = bench.static_floor_us(1080, 1920, cfg)
    assert frame_us == pytest.approx(1080 * 1920 * 3 / 3350e9 * 1e6)
    assert round(frame_us, 3) == 1.857
    assert spectrum_us == pytest.approx(2047 * 496 * (27 + 2 * k)
                                        / 67e12 * 1e6)
    if channels == 2:
        assert round(spectrum_us, 3) == 0.530
        assert round(frame_us + spectrum_us, 2) == 2.39
    assert bench.static_floor_us(1080, 1920, cfg, 1675.0)[0] == \
        pytest.approx(2 * frame_us)


@pytest.mark.parametrize("flags,mode,block,res,want", [
    ({}, "chunked", 8, (1080, 1920), "pool spectrum audio"),
    ({}, "scan", 8, (1080, 1920), "pool spectrum audio"),
    ({}, "scan", 1, (1080, 1920), "pool spectrum"),
    ({"PALLAS_AUDIO": "1"}, "scan", 1, (1080, 1920), "pool spectrum audio"),
    ({"PALLAS": "1"}, "scan", 0, (1080, 1920), "pool spectrum audio"),
    ({"QUANTIZE": "1"}, "chunked", 8, (1080, 1920), "spectrum audio"),
    ({"PALLAS_VISION": "1"}, "chunked", 8, (1080, 1920),
     "pool spectrum audio vision"),
    ({"PALLAS_VISION": "1"}, "chunked", 8, (2160, 3840),
     "pool spectrum audio"),                 # beyond K3's size bound
])
def test_expected_kernels(monkeypatch, flags, mode, block, res, want):
    for k, v in flags.items():
        monkeypatch.setenv(f"VAUDIO_BENCH_{k}", v)
    cfg = bench.bench_config(2)
    got = bench.expected_kernels(cfg, mode, block, *res)
    assert sorted(k for k, on in got.items() if on) == sorted(want.split())


def test_kernel_check_fails_on_a_missing_launch():
    before = {"pool": 5, "spectrum": 5, "audio": 5, "vision": 0}
    expected = {"pool": True, "spectrum": True, "audio": True,
                "vision": False}
    after = {"pool": 6, "spectrum": 6, "audio": 6, "vision": 0}
    assert bench.check_launches("t", before, after, expected) == {
        "pool": 1, "spectrum": 1, "audio": 1, "vision": 0}
    with pytest.raises(bench.KernelCheckError, match="K4"):
        bench.check_launches("t", before, dict(after, audio=5), expected)


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W", 500.0),
    ("NVIDIA H100, [N/A]", None),
    (None, None),
])
def test_power_limit_parse(line, want):
    assert bench.power_limit_w(line) == want


def test_cli_bench_runs_in_process(monkeypatch, capsys):
    """``vaudio_torch.cli.main(["bench"])`` runs the bench in this process
    and returns its code."""
    monkeypatch.setenv("VAUDIO_PLATFORM", "cpu")
    for k, v in dict(TINY, VAUDIO_BENCH_SCAN="0",
                     VAUDIO_BENCH_MONO="0").items():
        monkeypatch.setenv(k, v)
    assert cli.main(["bench"]) == 0
    rec = last_json(capsys.readouterr().out)
    assert rec["device"] == "cpu" and rec["value"] > 0


def test_cli_has_every_jax_subcommand():
    """The port's parser has each subcommand of ``vaudio/cli.py``, ``bench``
    among them."""
    with open(os.path.join(REPO, "vaudio", "cli.py")) as f:
        jax_cmds = set(re.findall(r'sub\.add_parser\(\s*"(\w+)"', f.read()))
    sub = cli.build_parser()._subparsers._group_actions[0]
    assert "bench" in jax_cmds and len(jax_cmds) == 11
    assert set(sub.choices) == jax_cmds
