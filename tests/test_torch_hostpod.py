"""The port's MultiHostPod (vaudio_torch.parallel.hostpod) on the CPU:
counterparts of tests/test_hostpod.py's TestSingleProcess and
TestTwoProcess::test_two_process_pod_matches_offline, and checkpoints that
cross between the two packages' pods.

Single-process cases run the multi-process code path over
``devices=["cpu"] * n`` (one process owning every mesh row); the
two-process case starts two OS processes of tests/torch_hostpod_driver.py
joined through torch.distributed on Gloo at 127.0.0.1, serving one 4-slot
global pod in lockstep.

The bands: the port's pod against the port's single-stream runs on the
CPU, equal bit for bit (per frame and in chunks); against the JAX
package's single-process pod, PCM within 2e-5 and hues equal; a checkpoint
written by one package's pod and restored into the other's continues bit
for bit with that package's run from the same carry.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import vaudio.parallel as jax_parallel
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.io import solid_color_frames
from vaudio.runtime.step import StepCarry as JaxStepCarry
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.parallel import MultiHostPod, make_stream_mesh
from vaudio_torch.runtime import MultiStreamAuralizer, chunked, step
from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine

HOP = 2048
TIMEOUT = 120.0
JAX_ATOL = 2e-5
COLORS = [
    [0.9, 0.2, 0.1],
    [0.1, 0.8, 0.3],
    [0.2, 0.3, 0.9],
    [0.8, 0.8, 0.1],
]


def clips(n_streams, n_frames, size=64, width=None):
    """tests/test_hostpod.py's solid-colour clips (f32)."""
    return [np.asarray(solid_color_frames(COLORS[s % len(COLORS)],
                                          width=width or size, height=size,
                                          num_frames=n_frames))
            for s in range(n_streams)]


def wait_done(pod, timeout=TIMEOUT):
    t0 = time.monotonic()
    while pod.is_running:
        if time.monotonic() - t0 > timeout:
            pod.stop()
            raise TimeoutError("pod producer still running")
        time.sleep(0.005)
    pod.raise_if_failed()


def tmpl(size=64):
    return np.zeros((size, size, 3), np.float32)


def mesh(n_stream):
    return make_stream_mesh(n_stream, 1, devices=["cpu"] * n_stream)


def hostpod(cfg, n_streams, engine=None, **kwargs):
    """The port's MultiHostPod on a CPU mesh of ``n_streams`` rows."""
    kwargs.setdefault("prefer_native", False)
    return MultiHostPod(cfg, n_streams, frame=kwargs.pop("frame", tmpl()),
                        mesh=kwargs.pop("mesh", mesh(n_streams)),
                        engine=engine or AuralizerEngine(cfg, device="cpu"),
                        **kwargs)


def offline(clip, cfg, chunk=1, carry=None):
    if chunk == 1:
        pcm, _, _ = step.run_offline(clip, cfg, carry=carry, device="cpu")
    else:
        pcm, _, _ = chunked.run_offline_batched(clip, cfg, chunk=chunk,
                                                carry=carry, device="cpu")
    return pcm.numpy().reshape(-1)


def jax_hostpod(cfg, n_streams, **kwargs):
    return jax_parallel.MultiHostPod(
        cfg, n_streams, frame=tmpl(), prefer_native=False,
        mesh=jax_parallel.make_stream_mesh(
            n_streams, 1, devices=jax.devices()[:n_streams]), **kwargs)


class TestSingleProcess:
    """The multi-process code path with one process owning every row."""

    def test_per_frame_matches_offline(self):
        cfg = AuralizerConfig()
        srcs = clips(4, 6)
        pod = hostpod(cfg, 4)
        assert pod.local_slice == slice(0, 4) and pod.n_streams == 4
        pod.start([iter(c) for c in srcs])
        wait_done(pod)
        for s in range(4):
            np.testing.assert_array_equal(pod.pull(s, 6 * HOP),
                                          offline(srcs[s], cfg))
        assert pod.metrics_dict()["local_slots"] == [0, 1, 2, 3]
        pod.stop()

    def test_chunked_matches_offline_batched(self):
        cfg = AuralizerConfig()
        srcs = clips(2, 6)
        pod = hostpod(cfg, 2, chunk_frames=3)
        pod.start([iter(c) for c in srcs])
        wait_done(pod)
        for s in range(2):
            np.testing.assert_array_equal(pod.pull(s, 6 * HOP),
                                          offline(srcs[s], cfg, chunk=3))
        pod.stop()

    def test_per_slot_params_are_sharded_with_streams(self):
        """Per-slot LiveParams survive the mesh distribution (the
        single-process mesh pod requires ONE shared object; this pod shards
        params with the streams): slot 1's stereo_width=0 collapses ITS
        image only."""
        cfg = AuralizerConfig(channels=2)
        clip = clips(1, 4)[0]
        params = [LiveParams(), LiveParams(stereo_width=0.0)]
        pod = hostpod(cfg, 2, params=params)
        pod.start([iter(clip), iter(clip.copy())])
        wait_done(pod)
        wide = pod.pull(0, 4 * HOP * 2).reshape(-1, 2)
        mono = pod.pull(1, 4 * HOP * 2).reshape(-1, 2)
        np.testing.assert_allclose(mono[:, 0], mono[:, 1], atol=1e-6)
        assert np.max(np.abs(wide[:, 0] - wide[:, 1])) > 1e-4
        pod.stop()

    def test_uneven_lengths_dark_slot(self):
        """Dark slots ride lockstep ticks as masked black frames; rings
        receive only real hops and the pod exits when every source is done
        (the activity sum)."""
        cfg = AuralizerConfig()
        long_clip, short_clip = clips(2, 6)
        pod = hostpod(cfg, 2)
        pod.start([iter(long_clip), iter(short_clip[:3])])
        wait_done(pod)
        assert pod.stream_metrics(0)["buffer_fill"] == 6
        assert pod.stream_metrics(1)["buffer_fill"] == 3
        np.testing.assert_array_equal(pod.pull(0, 6 * HOP),
                                      offline(long_clip, cfg))
        # Six real ticks and the all-dark tick on which the sources end:
        # a lockstep pod dispatches it (the JAX pod does too), and the
        # activity sum ends the loop on the next iteration.
        assert pod.metrics.dispatches == 7
        pod.stop()

    def test_all_dark_tick_still_dispatches(self):
        """A tick where every local slot is dark still dispatches (black
        frames, nothing written): a lockstep peer would be waiting."""
        cfg = AuralizerConfig()
        pod = hostpod(cfg, 2)
        batch, real = pod._next_batch()
        assert real == [False, False] and len(batch) == 2
        assert batch[0].shape == (64, 64, 3) and not batch[0].any()

    def test_orthomodes_engine(self):
        """The second model family: frame-sized carries built eagerly from
        the template, equal to the single-process pod."""
        cfg = AuralizerConfig()
        clip = clips(1, 4, size=32)[0]
        ref_pod = MultiStreamAuralizer(
            cfg, n_streams=1, engine=OrthoModesEngine(cfg, device="cpu"),
            prefer_native=False)
        ref_pod.start([iter(clip)])
        wait_done(ref_pod)
        ref = ref_pod.pull(0, 4 * HOP)
        ref_pod.stop()

        pod = hostpod(cfg, 2, engine=OrthoModesEngine(cfg, device="cpu"),
                      frame=tmpl(32))
        assert pod.snapshot_carry().phases.shape == (2, 1)   # 32 >> 5
        pod.start([iter(clip.copy()), iter(clip.copy())])
        wait_done(pod)
        np.testing.assert_array_equal(pod.pull(0, 4 * HOP), ref)
        np.testing.assert_array_equal(pod.pull(1, 4 * HOP), ref)
        pod.stop()

    def test_checkpoint_local_slice(self, tmp_path):
        """snapshot_carry returns THIS process's rows; save/load round-trips
        through the per-process file and the restored pod continues bit for
        bit."""
        cfg = AuralizerConfig()
        srcs = clips(2, 6)
        pod = hostpod(cfg, 2)
        pod.start([iter(c[:3]) for c in srcs])
        wait_done(pod)
        snap = pod.snapshot_carry()
        assert snap.hues.shape == (2, 16)
        path = str(tmp_path / "state.npz")
        pod.save_state(path)
        pod.stop()
        second = hostpod(cfg, 2)
        second.load_state(path)
        np.testing.assert_array_equal(second.snapshot_carry().hues,
                                      snap.hues)
        second.start([iter(c[3:]) for c in srcs])
        wait_done(second)
        for s in range(2):
            np.testing.assert_array_equal(
                second.pull(s, 3 * HOP),
                offline(srcs[s][3:], cfg, carry=snap._replace(
                    **{f: getattr(snap, f)[s] for f in snap._fields})))
        second.stop()

    def test_static_capacity(self):
        """resize is refused; acquire_slot leases free local slots but never
        grows past them."""
        cfg = AuralizerConfig()
        pod = hostpod(cfg, 2, exit_when_exhausted=False, realtime=True)
        with pytest.raises(RuntimeError, match="static capacity"):
            pod.resize(4)
        pod.start([iter(()), iter(())])
        try:
            t0 = time.monotonic()
            while len(pod.free_slots()) < 2:    # empty sources exhaust
                pod.raise_if_failed()
                assert time.monotonic() - t0 < TIMEOUT
                time.sleep(0.005)
            s0, _ = pod.acquire_slot()
            s1, _ = pod.acquire_slot()
            assert {s0, s1} == {0, 1}
            with pytest.raises(RuntimeError, match="at capacity"):
                pod.acquire_slot()
        finally:
            pod.stop()

    def test_validates_mesh_and_template(self):
        cfg = AuralizerConfig()
        with pytest.raises(ValueError, match="multiple of the mesh"):
            hostpod(cfg, 3, mesh=mesh(2))
        with pytest.raises(ValueError, match="DP-only"):
            hostpod(cfg, 4, mesh=make_stream_mesh(2, 2,
                                                  devices=["cpu"] * 4))
        with pytest.raises(ValueError, match="template rejected"):
            hostpod(cfg, 2, frame=np.zeros((64, 64, 4), np.float32))


class TestCrossPackageCheckpoint:
    """A single-process MultiHostPod checkpoint crosses between the
    packages: the same ``.npz`` format (the ``carry_type`` marker, five
    fields, their dtypes and the pod's shapes)."""

    def test_jax_checkpoint_continues_in_port(self, tmp_path):
        """The JAX pod runs 3 frames and saves; the port's pod on the same
        frames agrees with it (PCM within 2e-5, hues equal), and a port pod
        loads the JAX file and continues each slot bit for bit with the
        port's single-stream run from the same carry."""
        srcs = clips(2, 6)
        path = str(tmp_path / "jax.npz")
        cfg = AuralizerConfig()
        first = jax_hostpod(JaxConfig(), 2)
        mine = hostpod(cfg, 2)
        for p in (first, mine):
            p.start([iter(c[:3]) for c in srcs])
            wait_done(p)
        for s in range(2):
            np.testing.assert_allclose(mine.pull(s, 3 * HOP),
                                       first.pull(s, 3 * HOP), atol=JAX_ATOL)
        np.testing.assert_array_equal(
            mine.snapshot_carry().hues,
            np.asarray(first.snapshot_carry().hues))
        mine.stop()
        first.save_state(path)
        first.stop()
        data = np.load(path)
        assert str(data["carry_type"]) == "StepCarry"
        pod = hostpod(cfg, 2)
        pod.load_state(path)
        pod.start([iter(c[3:]) for c in srcs])
        wait_done(pod)
        for s in range(2):
            carry = {f: data[f][s] for f in JaxStepCarry._fields}
            np.testing.assert_array_equal(
                pod.pull(s, 3 * HOP), offline(srcs[s][3:], cfg, carry=carry))
        pod.stop()
        with pytest.raises(ValueError, match="pod size"):
            hostpod(cfg, 4).load_state(path)

    def test_port_checkpoint_continues_in_jax(self, tmp_path):
        """The port's pod runs 3 frames and saves; the JAX pod loads the
        file and continues bit for bit with the JAX pod given the same
        carry directly."""
        srcs = clips(2, 6)
        path = str(tmp_path / "port.npz")
        first = hostpod(AuralizerConfig(), 2)
        first.start([iter(c[:3]) for c in srcs])
        wait_done(first)
        first.save_state(path)
        snap = first.snapshot_carry()
        first.stop()
        restored = jax_hostpod(JaxConfig(), 2)
        restored.load_state(path)
        direct = jax_hostpod(JaxConfig(), 2)
        direct._carry = direct._shard_put(JaxStepCarry(*snap))
        for pod in (restored, direct):
            pod.start([iter(c[3:]) for c in srcs])
            wait_done(pod)
        for s in range(2):
            np.testing.assert_array_equal(restored.pull(s, 3 * HOP),
                                          direct.pull(s, 3 * HOP))
        restored.stop()
        direct.stop()


class TestTwoProcess:
    """Two OS processes, one CPU device each, Gloo on 127.0.0.1, one
    4-slot global pod in lockstep; each process serves its half and the
    parent holds every global slot to the port's single-process run."""

    def test_two_process_pod_matches_offline(self, tmp_path):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        # 144x192: the smallest solid-colour frame whose hue histogram
        # passes the count>20 gate, so each slot's audio differs and a
        # slot-routing mix-up cannot pass (tests/hostpod_driver.py).
        frames = np.stack(clips(4, 6, size=144, width=192))
        np.save(tmp_path / "clips.npy", frames)
        driver = os.path.join(os.path.dirname(__file__),
                              "torch_hostpod_driver.py")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(driver))]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        procs = [subprocess.Popen(
            [sys.executable, driver, str(pid), "2", str(port),
             str(tmp_path / "clips.npy"), str(tmp_path), "--chunk", "2",
             "--timeout", "60"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for pid in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {pid} failed:\n{out}"
            info = json.loads((tmp_path / f"proc_{pid}.json").read_text())
            assert info["slots"] == [2 * pid, 2 * pid + 2]
            assert info["ticks"] == 4    # 3 chunks + the all-dark tick
        cfg = AuralizerConfig()
        refs = [offline(frames[g], cfg, chunk=2) for g in range(4)]
        assert len({r.tobytes() for r in refs}) == 4   # distinct audio
        for g in range(4):
            np.testing.assert_array_equal(np.load(tmp_path / f"pcm_{g}.npy"),
                                          refs[g])
