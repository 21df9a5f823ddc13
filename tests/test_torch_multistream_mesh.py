"""The port's serving pod with a ``mesh`` (vaudio_torch.runtime.multistream
over vaudio_torch.parallel.StreamMesh) on the CPU, over
``devices=["cpu"] * 8``: the mesh cases of tests/test_multistream.py
(TestPodMesh, the 12 % 8 resize rejection, leases and shrinks in
stream-axis multiples), with trailing_shrink_target's ``mesh_step`` held
to the JAX function in tests/test_torch_multistream.py.

The bands: the data-parallel mesh pod against the port's single-stream
runs, equal bit for bit (per frame and in chunks, both families); the
(4, 2) tensor-parallel pod within the JAX test's 3e-4 of them, and within
2e-5 of the JAX package's (4, 2) mesh pod with hues equal.
"""

import time

import numpy as np
import pytest

import vaudio.runtime.multistream as jax_multistream
from torch_frames import structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.config import LiveParams as JaxLiveParams
from vaudio.parallel import make_stream_mesh as jax_make_stream_mesh
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.parallel import make_stream_mesh
from vaudio_torch.runtime import MultiStreamAuralizer, chunked
from vaudio_torch.runtime import step
from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine

HOP = 2048
TIMEOUT = 120.0
TP_ATOL = 3e-4           # tests/test_multistream.py::TestPodMesh's band
JAX_ATOL = 2e-5


def mesh(n_stream, n_cell=1):
    return make_stream_mesh(n_stream, n_cell,
                            devices=["cpu"] * (n_stream * n_cell))


def clips(n, T, size=64):
    return [structured_frames(s, T, size, size) for s in range(n)]


def mesh_pod(cfg, n_streams=8, shape=(8, 1), engine=None, **kwargs):
    return MultiStreamAuralizer(
        cfg, n_streams=n_streams, params=kwargs.pop("params", LiveParams()),
        mesh=mesh(*shape), prefer_native=False,
        engine=engine or AuralizerEngine(cfg, device="cpu"), **kwargs)


def wait_done(p, timeout=TIMEOUT):
    t0 = time.monotonic()
    while p.is_running:
        if time.monotonic() - t0 > timeout:
            p.stop()
            raise TimeoutError("pod producer still running")
        time.sleep(0.005)
    p.raise_if_failed()


def offline(clip, cfg, chunk=1):
    if chunk == 1:
        pcm, _, _ = step.run_offline(clip, cfg, device="cpu")
    else:
        pcm, _, _ = chunked.run_offline_batched(clip, cfg, chunk=chunk,
                                                device="cpu")
    return pcm.numpy().reshape(-1)


@pytest.mark.parametrize("shape,chunk", [
    ((8, 1), 1),    # pure stream-DP
    ((4, 2), 1),    # DP x cell-TP (the cell-order sum)
    ((8, 1), 2),    # DP chunk-batched (the throughput shape)
    ((2, 1), 2),    # four slots a shard
])
def test_mesh_pod_matches_offline(shape, chunk):
    cfg = AuralizerConfig()
    srcs = clips(8, 4)
    pod = mesh_pod(cfg, shape=shape, chunk_frames=chunk)
    pod.start([iter(c) for c in srcs])
    wait_done(pod)
    for s in (0, 3, 7):
        got, ref = pod.pull(s, 4 * HOP), offline(srcs[s], cfg, chunk)
        if shape[1] == 1:
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, ref, atol=TP_ATOL)
    assert pod.snapshot_carry().hues.shape == (8, 16)
    pod.stop()


def test_tp_mesh_pod_matches_jax_mesh_pod():
    """The (4, 2) pod against the JAX package's (4, 2) mesh pod, stereo."""
    srcs = clips(8, 3)
    ref = jax_multistream.MultiStreamAuralizer(
        JaxConfig(channels=2), n_streams=8, params=JaxLiveParams(),
        mesh=jax_make_stream_mesh(4, 2), prefer_native=False)
    ref.start([iter(c) for c in srcs])
    wait_done(ref)
    pod = mesh_pod(AuralizerConfig(channels=2), shape=(4, 2))
    pod.start([iter(c) for c in srcs])
    wait_done(pod)
    for s in range(8):
        np.testing.assert_allclose(pod.pull(s, 3 * HOP * 2),
                                   ref.pull(s, 3 * HOP * 2), atol=JAX_ATOL)
    np.testing.assert_array_equal(pod.snapshot_carry().hues,
                                  np.asarray(ref.snapshot_carry().hues))
    ref.stop()
    pod.stop()


def test_mesh_requires_shared_params():
    with pytest.raises(ValueError, match="shared LiveParams"):
        MultiStreamAuralizer(AuralizerConfig(), n_streams=8,
                             engine=AuralizerEngine(AuralizerConfig(),
                                                    device="cpu"),
                             mesh=mesh(8))
    with pytest.raises(ValueError, match="not a multiple"):
        mesh_pod(AuralizerConfig(), n_streams=6, shape=(4, 1))
    with pytest.raises(ValueError, match="flagship-specific"):
        mesh_pod(AuralizerConfig(), shape=(4, 2),
                 engine=OrthoModesEngine(AuralizerConfig(), device="cpu"))


def test_resize_validation_and_carry():
    """Resize in multiples of the stream axis (12 % 8 is refused); the
    surviving slots' carries ride along a grow and a shrink."""
    cfg = AuralizerConfig()
    pod = mesh_pod(cfg, shape=(4, 1))
    with pytest.raises(ValueError, match="multiple"):
        pod.resize(4 + 2)
    srcs = clips(8, 2)
    pod.start([iter(c) for c in srcs])
    wait_done(pod)
    before = pod.snapshot_carry()
    pod.resize(12)
    assert pod.n_streams == 12 and len(pod._carry) == 4
    grown = pod.snapshot_carry()
    np.testing.assert_array_equal(grown.phases[:8], before.phases)
    assert not grown.phases[8:].any() and (grown.running_max[8:] == 1).all()
    assert pod.params[11] is pod.params[0]       # the shared object
    pod.resize(4)
    np.testing.assert_array_equal(pod.snapshot_carry().hues,
                                  before.hues[:4])
    pod.stop()
    big = mesh_pod(cfg, shape=(8, 1))
    with pytest.raises(ValueError, match="multiple"):
        big.resize(12)                           # 12 % 8 != 0


def test_acquire_and_release_by_mesh_multiples():
    """A full mesh pod grows by a whole stream-axis multiple; a released
    trailing run shrinks back to a multiple."""
    cfg = AuralizerConfig()
    pod = mesh_pod(cfg, n_streams=2, shape=(2, 1), exit_when_exhausted=False)
    pod.start([iter(()), iter(())])
    try:
        t0 = time.monotonic()
        while len(pod.free_slots()) < 2:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < TIMEOUT
            time.sleep(0.005)
        slots = [pod.acquire_slot()[0] for _ in range(3)]
        assert slots == [0, 1, 2] and pod.n_streams == 4
        pod.release_slot(1, shrink=True)
        assert pod.n_streams == 4                # 3 rounds up to 4
        pod.release_slot(2, shrink=True)
        assert pod.n_streams == 2                # 1 rounds up to 2
    finally:
        pod.stop()


def test_orthomodes_mesh_pod_equals_single_device_pod():
    """The second family on the DP mesh (the engine's raw chunk step on
    each shard) against the one-device pod, bit for bit."""
    cfg = AuralizerConfig()
    srcs = [structured_frames(s, 4, 64, 96) for s in range(4)]

    def run(**kwargs):
        eng = OrthoModesEngine(cfg, device="cpu")
        p = MultiStreamAuralizer(eng.cfg, n_streams=4, engine=eng,
                                 params=LiveParams(), chunk_frames=2,
                                 prefer_native=False, **kwargs)
        p.start([iter(c) for c in srcs])
        wait_done(p)
        out = [p.pull(s, 4 * HOP) for s in range(4)]
        p.stop()
        return out

    for got, ref in zip(run(mesh=mesh(2)), run()):
        np.testing.assert_array_equal(got, ref)


def test_mesh_checkpoint_round_trip(tmp_path):
    """save_state joins the shards; load_state shards the file again and
    the pod continues bit for bit."""
    cfg = AuralizerConfig()
    srcs = clips(4, 6)      # 3 + 3: each half fills the 3-hop warm-up
    whole = mesh_pod(cfg, n_streams=4, shape=(2, 1))
    whole.start([iter(c) for c in srcs])
    wait_done(whole)
    first = mesh_pod(cfg, n_streams=4, shape=(2, 1))
    first.start([iter(c[:3]) for c in srcs])
    wait_done(first)
    path = str(tmp_path / "mesh.npz")
    first.save_state(path)
    assert np.load(path)["hues"].shape == (4, 16)
    second = mesh_pod(cfg, n_streams=4, shape=(4, 1))
    second.load_state(path)
    second.start([iter(c[3:]) for c in srcs])
    wait_done(second)
    for s in range(4):
        np.testing.assert_array_equal(
            np.concatenate([first.pull(s, 3 * HOP), second.pull(s, 3 * HOP)]),
            whole.pull(s, 6 * HOP))
    for p in (whole, first, second):
        p.stop()
