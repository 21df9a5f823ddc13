"""The port's command line (vaudio_torch.cli, ``python -m vaudio_torch``) on
the CPU, against the JAX package on the same numpy inputs.

Most cases call ``vaudio_torch.cli.main([...])`` in this process with
``VAUDIO_PLATFORM=cpu``; a few start ``python -m vaudio_torch`` (a signal,
two processes on Gloo, a served pod that clients talk to).  The reference
side is the JAX package's own objects on the same config, built by
``vaudio.cli._build_config`` from the same parsed flags; the JAX objects take
``prefer_native=False`` (the port's tests never load the JAX package's
native library).

Bands: PCM within 2e-5 of JAX; PCM16 WAV samples within 1 LSB; OrthoModes
within 5e-4 (ROADMAP queue 3); the port's CLI against the port in process,
and a mesh or two-process pod against the one-device pod, bit for bit.
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest
import torch

import vaudio.cli as jax_cli
from torch_frames import structured_frames
from vaudio.api import Auralizer as JaxAuralizer
from vaudio.io import hsb_frames as jax_hsb_frames
from vaudio.runtime import MultiStreamAuralizer as JaxPod
from vaudio.runtime import checkpoint as jax_checkpoint
from vaudio.runtime import step as jax_step
from vaudio.runtime.stream import StreamingAuralizer as JaxStream
from vaudio_torch import cli
from vaudio_torch.api import Auralizer
from vaudio_torch.client import PodClient
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.io import read_wav, write_wav
from vaudio_torch.runtime import MultiStreamAuralizer
from vaudio_torch.runtime.engine import AuralizerEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 2048
PCM_ATOL = 2e-5
ORTHO_ATOL = 5e-4
ORTHO_LSB = int(np.ceil(ORTHO_ATOL * 32767)) + 1   # the band, in PCM16
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("VAUDIO_PLATFORM", "cpu")
    monkeypatch.delenv("VAUDIO_NUM_CPU_DEVICES", raising=False)
    monkeypatch.delenv("VAUDIO_TOKEN", raising=False)


def module_env(**extra):
    env = dict(os.environ, VAUDIO_PLATFORM="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def jax_config(argv):
    """The JAX package's (config, params) for the same CLI flags."""
    return jax_cli._build_config(cli.build_parser().parse_args(argv))


def wav_i16(path):
    """A WAV's PCM16 samples and its (rate, channels)."""
    with wave.open(str(path)) as w:
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2"),
                (w.getframerate(), w.getnchannels()))


def assert_lsb(got, want, lsb=1):
    """Two WAVs of the same format whose PCM16 samples are within ``lsb``
    of each other."""
    (a, fa), (b, fb) = wav_i16(got), wav_i16(want)
    assert fa == fb and a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b).max() <= lsb


def save_clip(tmp_path, name, frames):
    """A clip as ``.npy`` and as a raw rgb24 file; returns both paths."""
    npy, raw = tmp_path / f"{name}.npy", tmp_path / f"{name}.rgb"
    np.save(npy, frames)
    frames.tofile(raw)
    return str(npy), str(raw)


class BinaryStdout(io.TextIOWrapper):
    """A stdout whose ``.buffer`` keeps the bytes (the stream's pipe)."""

    def __init__(self):
        super().__init__(io.BytesIO())

    def isatty(self):
        return False

    def pcm(self):
        return np.frombuffer(self.buffer.getvalue(), "<f4")


def run_stream(monkeypatch, argv):
    out = BinaryStdout()
    monkeypatch.setattr(sys, "stdout", out)
    assert cli.main(["stream", *argv]) == 0
    monkeypatch.undo()
    return out.pcm()


def jax_stream_pcm(frames, cfg):
    ref = JaxStream(cfg, prefer_native=False)
    ref.run_until_exhausted(list(frames), timeout=TIMEOUT)
    return ref.pull(len(frames) * cfg.hop_size * cfg.channels)


def wait_pod(pod):
    t0 = time.monotonic()
    while pod.is_running:
        pod.raise_if_failed()
        assert time.monotonic() - t0 < TIMEOUT, "pod still running"
        time.sleep(0.005)
    pod.raise_if_failed()


# ---------------------------------------------------------------------------
# Offline commands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["auralizer", "orthomodes"])
def test_synthetic_matches_jax(tmp_path, capsys, model):
    """``synthetic`` (f32 HSB frames) against the JAX package's
    ``Auralizer.sonify_to_wav`` on the same frames: PCM16 within 1 LSB
    (OrthoModes within its band)."""
    argv = ["--hue", "0.33", "--frames", "4", "--width", "64",
            "--height", "64", "--model", model]
    out = tmp_path / "port.wav"
    assert cli.main(["synthetic", *argv, "-o", str(out)]) == 0
    assert f"model={model}" in capsys.readouterr().out
    cfg, params = jax_config(["synthetic", *argv])
    ref = tmp_path / "jax.wav"
    JaxAuralizer(config=cfg, params=params, model=model,
                 prefer_native=False).sonify_to_wav(
        jax_hsb_frames(0.33, 1.0, 1.0, width=64, height=64, num_frames=4),
        str(ref))
    got, sr = read_wav(str(out))
    assert sr == 44100 and got.shape == (4 * HOP,)
    assert np.abs(got).max() > 0.01
    assert_lsb(out, ref, 1 if model == "auralizer" else ORTHO_LSB)


def test_sonify_npy_matches_jax(tmp_path, capsys):
    """``sonify clip.npy --channels 2`` on 12 u8 frames (the chunked
    pipeline) against JAX's ``sonify_to_wav``: PCM16 within 1 LSB, and
    equal to the port's in-process ``sonify`` quantised the same way."""
    frames = structured_frames(31, 12, 64, 64)
    npy, _ = save_clip(tmp_path, "clip", frames)
    out = tmp_path / "port.wav"
    argv = ["--channels", "2", "--sample-rate", "48000"]
    assert cli.main(["sonify", npy, "-o", str(out), *argv]) == 0
    assert "from 12 frames" in capsys.readouterr().out
    cfg, params = jax_config(["sonify", npy, *argv])
    ref = tmp_path / "jax.wav"
    JaxAuralizer(config=cfg, params=params,
                 prefer_native=False).sonify_to_wav(frames, str(ref))
    got, sr = read_wav(str(out))
    assert sr == 48000 and got.shape == (12 * HOP, 2)
    assert_lsb(out, ref)
    inproc = tmp_path / "inproc.wav"
    Auralizer(config=AuralizerConfig(sample_rate=48000.0, channels=2),
              device="cpu").sonify_to_wav(frames, str(inproc))
    assert out.read_bytes() == inproc.read_bytes()


def test_sonify_orthomodes_matches_jax(tmp_path, capsys):
    """``sonify --model orthomodes`` (stereo asked, coerced to mono with
    the JAX command's warning) against JAX's OrthoModes ``sonify_to_wav``
    within the OrthoModes band."""
    frames = structured_frames(32, 6, 64, 64)
    npy, _ = save_clip(tmp_path, "clip", frames)
    out = tmp_path / "port.wav"
    argv = ["--model", "orthomodes", "--channels", "2"]
    assert cli.main(["sonify", npy, "-o", str(out), *argv]) == 0
    assert "per-pixel model is mono" in capsys.readouterr().err
    cfg, params = jax_config(["sonify", npy, *argv])
    ref = tmp_path / "jax.wav"
    JaxAuralizer(config=cfg, params=params, model="orthomodes",
                 prefer_native=False).sonify_to_wav(frames, str(ref))
    assert read_wav(str(out))[0].shape == (6 * HOP,)
    assert_lsb(out, ref, ORTHO_LSB)


def test_debug_renders_the_jax_artifacts(tmp_path, capsys):
    """``debug synthetic`` writes the JAX command's artifact set."""
    assert cli.main(["debug", "synthetic", "--frames", "3",
                     "-o", str(tmp_path / "dbg")]) == 0
    out = capsys.readouterr().out
    assert "debug artifacts" in out
    names = set(os.listdir(tmp_path / "dbg"))
    for want in ("hue_matrix.png", "spectrum.png", "waveform.png",
                 "grid_overlay.json"):
        assert want in names, names


def test_info_matches_jax_config_defaults(capsys):
    """``info`` prints the JAX command's ``config_defaults`` and ``derived``
    and, in place of its backend, torch's version and the device."""
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    jax_cli.cmd_info(None)
    ref = json.loads(capsys.readouterr().out)
    assert info["config_defaults"] == ref["config_defaults"]
    assert info["derived"] == ref["derived"]
    assert info["version"] == ref["version"]
    assert info["torch"] == torch.__version__
    assert info["device"] == "cpu" and info["devices"] == ["cpu"]
    assert "jax_backend" not in info


def test_python_m_runs_the_cli():
    """``python -m vaudio_torch info`` in a fresh interpreter imports no
    jax; ``bench`` is a command (the port's benchmark,
    ``vaudio_torch.bench``) without flags, and ``parity`` takes the JAX
    CLI's flags and defaults."""
    code = ("import runpy, sys\n"
            "sys.argv = ['vaudio_torch', 'info']\n"
            "try:\n"
            "    runpy.run_module('vaudio_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules and 'vaudio' not in "
            "sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=module_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["devices"] == ["cpu"]
    assert cli.build_parser().parse_args(["bench"]).fn is cli.cmd_bench
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["bench", "--frames", "1"])
    args = cli.build_parser().parse_args(["parity"])
    assert (args.frames, args.size) == (3, 128)


@pytest.mark.parametrize("argv", [
    ["synthetic", "--frames", "1"],
    ["sonify", "clip.npy"],
    ["debug", "synthetic"],
    ["info"],
    ["stream", "--size", "8x8"],
    ["pod", "--size", "8x8", "--input", "clip.npy"],
    ["parity", "--frames", "1", "--size", "16"],
    ["bench"],
])
def test_without_a_card_computing_commands_fail(monkeypatch, capsys,
                                                argv):
    """Without a card and without VAUDIO_PLATFORM=cpu, a command that
    computes exits non-zero with vaudio_torch.device()'s message, before
    it reads any input: nothing falls back to the CPU quietly."""
    monkeypatch.delenv("VAUDIO_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "torch.cuda.is_available() is False" in str(e.value.code)
    monkeypatch.setenv("VAUDIO_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="expected cpu or cuda"):
        cli.main(argv)


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def test_stream_pipe_matches_jax_stream(tmp_path, monkeypatch):
    """``stream`` in pipe mode from a raw rgb24 file, stereo: the f32 PCM
    on stdout equals the port's in-process stream bit for bit and the JAX
    package's stream within 2e-5."""
    frames = structured_frames(33, 6, 64, 64)
    _, raw = save_clip(tmp_path, "clip", frames)
    argv = ["--size", "64x64", "--input", raw, "--channels", "2"]
    got = run_stream(monkeypatch, argv)
    cfg = AuralizerConfig(channels=2)
    aur = Auralizer(source=frames, config=cfg, device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    np.testing.assert_array_equal(got, aur.pull(6 * HOP * 2))
    jcfg, _ = jax_config(["stream", *argv])
    np.testing.assert_allclose(got, jax_stream_pcm(frames, jcfg),
                               atol=PCM_ATOL)


def test_stream_chunked_metrics_log_and_trace(tmp_path, monkeypatch):
    """``stream --chunk-frames 4 --metrics-log --trace`` on 6 frames: the
    log counts every frame, the PCM equals the in-process stream's with the
    same dispatches, and the torch.profiler trace holds the producer
    thread's ops."""
    frames = structured_frames(34, 6, 64, 64)
    _, raw = save_clip(tmp_path, "clip", frames)
    log, trace = tmp_path / "m.jsonl", tmp_path / "trace"
    got = run_stream(monkeypatch, [
        "--size", "64x64", "--input", raw, "--chunk-frames", "4",
        "--metrics-log", str(log), "--trace", str(trace)])
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert sum(r["frames"] for r in records) == 6
    aur = Auralizer(source=frames, device="cpu", chunk_frames=4)
    aur.run_until_exhausted(timeout=TIMEOUT)
    np.testing.assert_array_equal(got, aur.pull(6 * HOP))
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::copy_" in names


def test_stream_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    """A carry saved by the JAX package after 4 frames, resumed by the
    port's ``stream --load-state`` on the next 4: within 2e-5 of JAX
    continuing it; the port's ``--save-state`` then continues in JAX."""
    frames = structured_frames(35, 8, 64, 64)
    _, raw = save_clip(tmp_path, "rest", frames[4:])
    jcfg, _ = jax_config(["stream", "--channels", "2"])
    _, c4, _ = jax_step.run_offline(frames[:4], jcfg)
    state, saved = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_checkpoint.save_state(str(state), c4)
    got = run_stream(monkeypatch, [
        "--size", "64x64", "--input", raw, "--channels", "2",
        "--load-state", str(state), "--save-state", str(saved)])
    ref, c8, _ = jax_step.run_offline(frames[4:], jcfg, carry=c4)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(-1),
                               atol=PCM_ATOL)
    restored = jax_checkpoint.load_state(str(saved), jcfg)
    np.testing.assert_array_equal(np.asarray(restored.hues),
                                  np.asarray(c8.hues))


def test_stream_sigterm_flushes_and_saves_state(tmp_path):
    """SIGTERM mid-stream exits 143 with the PCM flushed, 'interrupted'
    reported and ``--save-state`` written (the carry read before stop()
    clears the OLA tail)."""
    frames = structured_frames(36, 6, 64, 64)
    ckpt = tmp_path / "sig.npz"
    p = subprocess.Popen(
        [sys.executable, "-m", "vaudio_torch", "stream", "--size", "64x64",
         "--save-state", str(ckpt)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=module_env(), cwd=REPO)
    try:
        # Frames in, stdin left open: the stream stays live until the
        # signal arrives.
        p.stdin.write(frames.tobytes())
        p.stdin.flush()
        pcm0 = p.stdout.read(HOP * 4)          # one hop of f32 PCM
        assert len(pcm0) == HOP * 4
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=TIMEOUT)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 143, err.decode()[-2000:]
    assert b"interrupted; shutting down cleanly" in err
    assert b"DSP state saved" in err
    pcm = np.frombuffer(pcm0 + out, "<f4")
    data = np.load(ckpt)
    assert "phases" in data.files
    assert np.abs(data["ola_tail"]).max() > 0      # saved before stop()
    aur = Auralizer(source=frames, device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    np.testing.assert_array_equal(pcm, aur.pull(6 * HOP)[:len(pcm)])


# ---------------------------------------------------------------------------
# pod
# ---------------------------------------------------------------------------

def pod_clips(tmp_path, n=3, frames=5, size=64):
    clips = [structured_frames(40 + s, frames, size, size)
             for s in range(n)]
    paths = []
    for s, c in enumerate(clips):
        npy, raw = save_clip(tmp_path, f"slot{s}", c)
        paths.append(raw if s % 2 else npy)      # both kinds of input
    return clips, paths


def pod_wavs(outdir, n):
    return [read_wav(os.path.join(outdir, f"slot{i}.wav"))[0]
            for i in range(n)]


@pytest.mark.parametrize("chunk", [1, 2])
def test_pod_slots_match_jax_pod(tmp_path, capsys, chunk):
    """``pod`` with 3 file slots (.npy and raw rgb24): each slotN.wav
    within 1 LSB of the JAX pod's slot on the same frames."""
    clips, paths = pod_clips(tmp_path)
    argv = ["--size", "64x64", "--chunk-frames", str(chunk)]
    for p in paths:
        argv += ["--input", p]
    out = tmp_path / "out"
    assert cli.main(["pod", *argv, "-o", str(out)]) == 0
    assert "pod: 15 frames over 3 streams" in capsys.readouterr().err
    cfg, params = jax_config(["pod", *argv])
    ref = JaxPod(cfg, n_streams=3, chunk_frames=chunk, prefer_native=False)
    ref.start([iter(c) for c in clips])
    wait_pod(ref)
    for i in range(3):
        want = tmp_path / f"jax{i}.wav"
        write_wav(str(want), ref.pull(i, 5 * HOP), cfg.sample_rate)
        assert read_wav(str(want))[0].shape == (5 * HOP,)
        assert_lsb(out / f"slot{i}.wav", want)
    ref.stop()


@pytest.mark.parametrize("model", ["auralizer", "orthomodes"])
def test_pod_mesh(tmp_path, monkeypatch, capsys, model):
    """``pod --mesh 2`` with ``VAUDIO_NUM_CPU_DEVICES=4`` lays the stream
    axis over 2 of the 4 devices (the JAX wording), and ``--mesh 2x2``
    (flagship) over one device repeats it and says so; every slot equals
    the one-device pod's bit for bit."""
    clips, paths = pod_clips(tmp_path, n=2, frames=4)
    argv = ["pod", "--size", "64x64", "--model", model]
    for p in paths:
        argv += ["--input", p]
    assert cli.main([*argv, "-o", str(tmp_path / "one")]) == 0
    monkeypatch.setenv("VAUDIO_NUM_CPU_DEVICES", "4")
    assert cli.main([*argv, "-o", str(tmp_path / "mesh"),
                     "--mesh", "2"]) == 0
    assert "device mesh stream=2 cell=1 (2 of 4 devices)" in \
        capsys.readouterr().err
    one = pod_wavs(tmp_path / "one", 2)
    for a, b in zip(one, pod_wavs(tmp_path / "mesh", 2)):
        assert a.shape == (4 * HOP,)
        np.testing.assert_array_equal(a, b)
    if model == "auralizer":
        monkeypatch.delenv("VAUDIO_NUM_CPU_DEVICES")
        assert cli.main([*argv, "-o", str(tmp_path / "tp"),
                         "--mesh", "2x2"]) == 0
        assert "device mesh stream=2 cell=2 (4 shards over 1 device(s), " \
               "each repeated)" in capsys.readouterr().err
        for i in range(2):
            assert_lsb(tmp_path / "tp" / f"slot{i}.wav",
                       tmp_path / "one" / f"slot{i}.wav")


@pytest.mark.parametrize("mesh,inputs,message", [
    ("2", 3, "not a multiple of the --mesh stream axis"),
    ("0", 1, "axes must be >= 1"),
    ("2y", 2, "--mesh must be DP or DPxTP"),
])
def test_pod_mesh_validation(tmp_path, mesh, inputs, message):
    argv = ["pod", "--size", "64x64", "--mesh", mesh, "-o",
            str(tmp_path / "o")] + ["--input", "x.npy"] * inputs
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


def test_pod_checkpoint_split_equals_whole(tmp_path):
    """``pod --save-state`` / ``--load-state``: a pod split across two runs
    gives the same PCM as one continuous run, per slot."""
    clips = [structured_frames(50 + s, 6, 64, 64) for s in range(2)]

    def run(lo, hi, out, *extra):
        argv = ["pod", "--size", "64x64", "-o", str(tmp_path / out),
                *extra]
        for s, c in enumerate(clips):
            p = tmp_path / f"{out}_{s}.npy"
            np.save(p, c[lo:hi])
            argv += ["--input", str(p)]
        assert cli.main(argv) == 0
        return pod_wavs(tmp_path / out, 2)

    ckpt = str(tmp_path / "pod.npz")
    first = run(0, 3, "first", "--save-state", ckpt)
    second = run(3, 6, "second", "--load-state", ckpt)
    whole = run(0, 6, "whole")
    for a, b, w in zip(first, second, whole):
        np.testing.assert_array_equal(np.concatenate([a, b]), w)


def test_two_process_pod_coordinator(tmp_path):
    """Two ``pod --coordinator`` processes on Gloo serve one 4-slot pod,
    2 slots each: every global slot equals the single-process pod's bit
    for bit."""
    clips = [structured_frames(60 + s, 4, 64, 64) for s in range(4)]
    for g, c in enumerate(clips):
        np.save(tmp_path / f"g{g}.npy", c)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vaudio_torch", "pod", "--size", "64x64",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), "-o", str(tmp_path / f"out{pid}"),
         "--input", str(tmp_path / f"g{2 * pid}.npy"),
         "--input", str(tmp_path / f"g{2 * pid + 1}.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=module_env(), cwd=REPO) for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        assert f"global slots {2 * pid}..{2 * pid + 1} served here" in log
    eng = AuralizerEngine(AuralizerConfig(), device="cpu")
    ref = MultiStreamAuralizer(eng.cfg, n_streams=4, engine=eng)
    ref.start([iter(c) for c in clips])
    wait_pod(ref)
    got = pod_wavs(tmp_path / "out0", 2) + pod_wavs(tmp_path / "out1", 2)
    wants = []
    for g in range(4):
        want = tmp_path / f"ref{g}.wav"
        write_wav(str(want), ref.pull(g, 4 * HOP), 44100.0)
        wants.append(read_wav(str(want))[0])
        np.testing.assert_array_equal(got[g], wants[g])
    assert len({w.tobytes() for w in wants}) == 4     # distinct slots
    ref.stop()


# ---------------------------------------------------------------------------
# Serving: pod --serve, push, pull, doctor --url
# ---------------------------------------------------------------------------

def scan_url(proc, pattern=r"live panel at (http://\S+)", timeout=120):
    """The panel URL a served process prints on stderr (bounded wait)."""
    found, box = threading.Event(), {}

    def scan():
        for line in proc.stderr:
            box.setdefault("lines", []).append(line)
            m = re.search(pattern, line)
            if m and not found.is_set():
                box["url"] = m.group(1).rstrip("/")
                found.set()
        found.set()

    threading.Thread(target=scan, daemon=True).start()
    assert found.wait(timeout) and "url" in box, box.get("lines")
    return box


def test_served_pod_with_push_pull_and_doctor(tmp_path, capsys):
    """One ``pod --serve`` process: a mesh of 2 over repeated CPU devices,
    a token, two push doors (``push`` and ``push:dark``), leases with
    reaping and the idle shrink.  The port's ``push`` CLI feeds slot 0, its
    ``pull`` records slot 0, ``doctor --url`` judges the panel healthy, a
    lease grows the pod, and the reaper and the shrink return it."""
    pod = subprocess.Popen(
        [sys.executable, "-m", "vaudio_torch", "pod", "--size", "32x32",
         "--input", "push", "--input", "push:dark", "--serve", "0",
         "--token", "tok", "--mesh", "2", "--max-streams", "4",
         "--lease-timeout", "2", "--idle-shrink", "2",
         "-o", str(tmp_path / "out")],
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=module_env(VAUDIO_NUM_CPU_DEVICES="2"))
    try:
        box = scan_url(pod)
        url = box["url"]
        client = PodClient(url, token="tok")
        # A lease while both doors are armed grows the pod by a mesh
        # stream-axis multiple; its client then dies after two frames.
        slot = client.acquire(when_empty="dark")
        assert slot.index == 2 and client.n_streams == 4
        clip = structured_frames(70, 5, 32, 32)
        for fr in clip[:2]:
            slot.push(fr)
        np.save(tmp_path / "clip.npy", clip)
        assert cli.main(["push", "--url", url, "--slot", "0", "--input",
                         str(tmp_path / "clip.npy"), "--token", "tok",
                         "--no-close"]) == 0
        assert f"push: 5 frames -> {url} slot 0" in capsys.readouterr().err
        t0 = time.monotonic()
        while client.metrics()["frames_processed"] < 7:
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.05)
        wav = tmp_path / "pulled.wav"
        assert cli.main(["pull", "--url", url, "--slot", "0",
                         "--seconds", "0.05", "-o", str(wav),
                         "--token", "tok"]) == 0
        with wave.open(str(wav)) as w:
            assert w.getframerate() == 44100 and w.getnchannels() == 1
            assert w.getnframes() == int(round(0.05 * 44100))
        assert cli.main(["doctor", "--url", url, "--token", "tok",
                         "--skip-backend", "--skip-smoke", "--json"]) == 0
        checks = {c["name"]: c for c in json.loads(
            capsys.readouterr().out)}
        assert checks["panel"]["status"] == "ok", checks["panel"]
        # Both go silent: the reaper closes slot 0's fed door and the
        # lease, the idle shrink returns the capacity in a mesh multiple;
        # the unfed push:dark door survives.
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            m = client.metrics()
            if m["leases_reaped"] >= 2 and m["n_streams"] == 2:
                break
            time.sleep(0.2)
        assert m["leases_reaped"] == 2 and m["auto_shrinks"] == 1, m
        assert m["slots"][1]["push"]["closed"] is False, m["slots"]
        assert not any(s["failed"] for s in m["slots"]), m["slots"]
        assert all(np.isfinite(read_wav(str(wav))[0]))
    finally:
        pod.terminate()
        try:
            pod.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pod.kill()
            pod.wait()


def served_port_pod(n, max_streams, size=32):
    eng = AuralizerEngine(AuralizerConfig(), device="cpu")
    pod = MultiStreamAuralizer(eng.cfg, n_streams=n, engine=eng,
                               exit_when_exhausted=False,
                               max_streams=max_streams)
    server = pod.serve(port=0)
    pod.start([iter(())] * n)
    return pod, server


def test_push_cli_fleet_mode(tmp_path, capsys):
    """``push`` with two ``--url`` and ``--slot acquire`` leases on the pod
    with the most capacity and pushes every frame there."""
    small, s_srv = served_port_pod(1, 1)
    big, b_srv = served_port_pod(1, 3)
    try:
        clip = structured_frames(71, 4, 32, 32)
        np.save(tmp_path / "clip.npy", clip)
        assert cli.main(["push", "--url", s_srv.url, "--url", b_srv.url,
                         "--slot", "acquire", "--input",
                         str(tmp_path / "clip.npy")]) == 0
        err = capsys.readouterr().err
        assert f"fleet leased slot 0 on {b_srv.url.rstrip('/')}" in err
        assert "push: 4 frames" in err
        t0 = time.monotonic()
        while big.metrics.frames_processed < 4:
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.01)
        assert small.metrics.frames_processed == 0
        with pytest.raises(SystemExit, match="need --slot acquire"):
            cli.main(["push", "--url", s_srv.url, "--url", b_srv.url,
                      "--input", str(tmp_path / "clip.npy")])
    finally:
        for srv, pod in ((s_srv, small), (b_srv, big)):
            srv.stop()
            pod.stop()


def test_port_push_into_a_jax_pod(tmp_path, capsys):
    """The port's ``push`` CLI feeds the JAX package's PodServer: every
    frame arrives and the slot sounds."""
    cfg, _ = jax_config(["pod", "--size", "32x32"])
    pod = JaxPod(cfg, n_streams=1, exit_when_exhausted=False,
                 prefer_native=False)
    server = pod.serve(port=0)
    try:
        pod.start([iter(())])
        clip = structured_frames(72, 4, 32, 32)
        np.save(tmp_path / "clip.npy", clip)
        assert cli.main(["push", "--url", server.url, "--slot", "0",
                         "--input", str(tmp_path / "clip.npy"),
                         "--when-empty", "dark"]) == 0
        assert "push: 4 frames" in capsys.readouterr().err
        t0 = time.monotonic()
        while pod.metrics.frames_processed < 4:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.01)
        assert np.abs(pod.pull(0, 4 * HOP)).max() > 0
    finally:
        server.stop()
        pod.stop()


def test_pull_cli_records_a_port_slot(tmp_path, capsys):
    """``pull`` records a served port pod's slot to a WAV with the pod's
    rate and channels; with neither -o nor --play it refuses."""
    pod, server = served_port_pod(1, 1)
    try:
        out = tmp_path / "slot0.wav"
        assert cli.main(["pull", "--url", server.url, "--slot", "0",
                         "--seconds", "0.1", "-o", str(out)]) == 0
        assert "pull: wrote 4410 samples" in capsys.readouterr().err
        with wave.open(str(out)) as w:
            assert w.getframerate() == 44100 and w.getnchannels() == 1
            assert w.getnframes() == 4410
        with pytest.raises(SystemExit, match="nothing to do"):
            cli.main(["pull", "--url", server.url])
    finally:
        server.stop()
        pod.stop()
