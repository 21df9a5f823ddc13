"""The port's multi-device layer (vaudio_torch.parallel.sharding and
.multihost) on the CPU, counterparts of tests/test_parallel.py: the JAX side
runs on the 8 virtual CPU devices of tests/conftest.py, the port's side on
``make_stream_mesh(..., devices=["cpu"] * 8)``, on the same seeded frames.

The bands:

- The port's mesh steps against the JAX package's on the same mesh shape:
  PCM within 2e-5 (measured <= 3.3e-6 on every shape, mono and stereo),
  hues equal.
- The port's mesh steps against its own one-device batched step: the JAX
  test's 3e-4 with hues equal; the data-parallel shapes are equal bit for
  bit (a shard runs the same stream-batched step on fewer rows).
- The DP chunk step and the DP pod against the port's single-stream runs:
  equal bit for bit; the TP shapes within the JAX test's 3e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.parallel import init_carry_batch as jax_init_carry_batch
from vaudio.parallel import make_parallel_step as jax_make_parallel_step
from vaudio.parallel import make_stream_mesh as jax_make_stream_mesh
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.ops import spectrum_kernel
from vaudio_torch.parallel import (MultiHostAuralizer, StreamMesh,
                                   distribute_local_frames, init_carry_batch,
                                   init_distributed, local_stream_slice,
                                   make_batched_step,
                                   make_engine_parallel_step,
                                   make_multihost_mesh,
                                   make_parallel_chunk_step,
                                   make_parallel_step, make_stream_mesh,
                                   run_offline_parallel, sharding)
from vaudio_torch.parallel.dryrun import dryrun_multichip
from vaudio_torch.runtime import chunked, step
from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine

CFG = AuralizerConfig()
PARAMS = LiveParams().as_arrays()
CPU8 = ["cpu"] * 8
HOP = 2048
JAX_ATOL = 2e-5          # the port against the JAX package (docstring)
TP_ATOL = 3e-4           # tests/test_parallel.py's band for the TP mesh
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def frames8():
    """tests/test_parallel.py's frames: 8 streams of 3 frames, 64x64."""
    rng = np.random.default_rng(42)
    return rng.uniform(0, 1, (8, 3, 64, 64, 3)).astype(np.float32)


def mesh(n_stream, n_cell=1):
    return make_stream_mesh(n_stream, n_cell, devices=CPU8[:n_stream * n_cell])


def run_port(step_fn, cfg, frames, n_frames=2):
    """``n_frames`` chained steps of the port from a cold batched carry:
    (PCM of each step as numpy, final carry as one tree)."""
    carry = init_carry_batch(cfg, frames.shape[0], "cpu")
    pcm = []
    for t in range(n_frames):
        carry, out = step_fn(carry, frames[:, t], PARAMS)
        pcm.append(out["pcm"].numpy())
    if isinstance(carry, sharding.StreamShards):
        carry = carry.gather()
    return pcm, carry


_cache = {}


def port_tp(shape, frames8, **flags):
    key = ("tp", shape, tuple(sorted(flags.items())))
    if key not in _cache:
        cfg = AuralizerConfig(**flags)
        _cache[key] = run_port(make_parallel_step(cfg, mesh(*shape)), cfg,
                               frames8)
    return _cache[key]


def port_batched(frames8, **flags):
    key = ("batched", tuple(sorted(flags.items())))
    if key not in _cache:
        cfg = AuralizerConfig(**flags)
        _cache[key] = run_port(make_batched_step(cfg, device="cpu"), cfg,
                               frames8)
    return _cache[key]


def test_mesh_layout():
    m = make_stream_mesh(4, 2, devices=CPU8)
    assert m.shape == {"stream": 4, "cell": 2}
    assert m.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.local_rows == [0, 1, 2, 3]
    assert make_stream_mesh(devices=CPU8).shape == {"stream": 8, "cell": 1}
    with pytest.raises(ValueError, match="cannot lay 8 devices"):
        make_stream_mesh(3, 2, devices=CPU8)
    with pytest.raises(ValueError, match="grid of devices"):
        StreamMesh(np.array(["cpu"] * 4, dtype=object))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_mesh_default_needs_a_card():
    with pytest.raises(RuntimeError, match="is_available"):
        make_stream_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        make_multihost_mesh()


class TestParallelStep:
    @pytest.mark.parametrize("shape", MESHES)
    def test_matches_jax_mesh(self, frames8, shape):
        """The port's mesh step against the JAX mesh step on the same
        shape (tests/test_parallel.py::test_matches_single_device's mesh),
        two chained steps."""
        jstep = jax_make_parallel_step(JaxConfig(),
                                       jax_make_stream_mesh(*shape))
        carry = jax_init_carry_batch(JaxConfig(), 8)
        ref = []
        for t in range(2):
            carry, out = jstep(carry, jnp.asarray(frames8[:, t]), PARAMS)
            ref.append(np.asarray(out["pcm"]))
        pcm, got = port_tp(shape, frames8)
        for a, b in zip(pcm, ref):
            np.testing.assert_allclose(a, b, atol=JAX_ATOL)
        np.testing.assert_array_equal(got.hues.numpy(),
                                      np.asarray(carry.hues))
        np.testing.assert_array_equal(got.phases.numpy(),
                                      np.asarray(carry.phases))

    @pytest.mark.parametrize("shape", MESHES)
    def test_matches_single_device(self, frames8, shape):
        """tests/test_parallel.py::test_matches_single_device: the mesh
        step against the one-device batched step (DP shapes bit for
        bit)."""
        pcm, got = port_tp(shape, frames8)
        ref, carry = port_batched(frames8)
        for a, b in zip(pcm, ref):
            if shape[1] == 1:
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, b, atol=TP_ATOL)
        np.testing.assert_array_equal(got.hues.numpy(), carry.hues.numpy())

    @pytest.mark.parametrize("flags", [
        {"channels": 2},
        {"enable_filters": True},
        {"channels": 2, "enable_filters": True},
        {"quirk_compat": False},
        {"linear_cell_grads": False},
    ], ids=lambda f: "+".join(f"{k}={v}" for k, v in f.items()))
    def test_flag_matrix_on_tp_mesh(self, frames8, flags):
        """Every config flag survives the (4,2) DP+TP decomposition
        (tests/test_parallel.py::test_flag_matrix_on_tp_mesh)."""
        cfg = AuralizerConfig(**flags)
        params = dict(PARAMS)
        if flags.get("enable_filters"):
            params.update(hp_cutoff=np.float32(500.0),
                          hp_order=np.float32(2.0),
                          lp_cutoff=np.float32(4000.0),
                          lp_order=np.float32(1.0))
        tp = make_parallel_step(cfg, mesh(4, 2))
        one = make_batched_step(cfg, device="cpu")
        carry_p = carry_b = init_carry_batch(cfg, 8, "cpu")
        for t in range(2):
            carry_p, out_p = tp(carry_p, frames8[:, t], params)
            carry_b, out_b = one(carry_b, frames8[:, t], params)
            np.testing.assert_allclose(out_p["pcm"].numpy(),
                                       out_b["pcm"].numpy(), atol=TP_ATOL)
        np.testing.assert_array_equal(carry_p.gather().hues.numpy(),
                                      carry_b.hues.numpy())
        assert np.abs(out_p["pcm"].numpy()).max() > 1e-3

    def test_stereo_image_survives_tp(self):
        """An off-center hue field gives L != R through the TP mesh (the
        pan law is sliced per cell range)."""
        cfg = AuralizerConfig(channels=2)
        frame = np.zeros((64, 64, 3), np.float32)
        frame[:, 48:] = [1.0, 0.1, 0.1]           # color mass on the right
        frames = np.broadcast_to(frame, (8, 64, 64, 3))
        stepP = make_parallel_step(cfg, mesh(4, 2))
        carry, out = stepP(init_carry_batch(cfg, 8, "cpu"), frames, PARAMS)
        carry, out = stepP(carry, frames, PARAMS)  # past warm-up silence
        pcm = out["pcm"].numpy()                   # (8, hop, 2)
        assert pcm.shape == (8, HOP, 2)
        el = np.abs(pcm[0, :, 0]).sum()
        er = np.abs(pcm[0, :, 1]).sum()
        assert el > 0 and er > 0 and not np.isclose(el, er, rtol=1e-3)

    @pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
    def test_cell_reduction_structure(self, monkeypatch, shape):
        """Standing in for test_collective_present_in_hlo: on a cell axis
        of n the contraction (K2's plain version on the CPU) runs on NP =
        496/n partials on each device of a row, and the cell sum runs once
        a stream row a step; a cell axis of 1 has no sum."""
        seen = []
        plain = spectrum_kernel.hann_peak_weighted_sum_plain

        def spy(freqs, pfreq, scale, weights):
            seen.append(tuple(pfreq.shape))
            return plain(freqs, pfreq, scale, weights)
        monkeypatch.setattr(spectrum_kernel, "hann_peak_weighted_sum_plain",
                            spy)
        n_stream, n_cell = shape
        stepP = make_parallel_step(CFG, mesh(*shape))
        before = sharding.cell_reductions
        stepP(init_carry_batch(CFG, 2 * n_stream, "cpu"),
              np.zeros((2 * n_stream, 64, 64, 3), np.float32), PARAMS)
        assert sharding.cell_reductions - before == (
            n_stream if n_cell > 1 else 0)
        assert seen == [(2, 496 // n_cell)] * (n_stream * n_cell)

    def test_tp_needs_divisible_cells(self):
        with pytest.raises(ValueError, match="not divisible"):
            make_parallel_step(CFG, make_stream_mesh(1, 3,
                                                     devices=["cpu"] * 3))


class TestParallelChunked:
    def test_chunked_dp_matches_offline(self, frames8):
        """The DP x chunk-batched pipeline against the per-stream chunked
        runs, bit for bit."""
        audio, final, _ = run_offline_parallel(frames8, CFG, mesh(8, 1),
                                               PARAMS, pipeline="chunked")
        audio = audio.numpy()
        assert audio.shape == (8, 3 * HOP)
        for s in (0, 7):
            ref, _, _ = chunked.run_offline_batched(frames8[s], CFG, PARAMS,
                                                    chunk=3, device="cpu")
            np.testing.assert_array_equal(audio[s], ref.numpy())
        assert final.gather().hues.shape == (8, 16)

    def test_debug_outputs_returned(self, frames8):
        for pipeline in ("chunked", "scan"):
            _a, _f, dbg = run_offline_parallel(
                frames8, CFG, mesh(8, 1), PARAMS, debug=True,
                pipeline=pipeline)
            assert tuple(dbg["hues"].shape) == (8, 3, 16), pipeline
            assert tuple(dbg["spectrum"].shape) == (8, 3, 2047, 2), pipeline

    def test_auto_picks_chunked_on_dp_mesh(self, frames8):
        a1, _, _ = run_offline_parallel(frames8, CFG, mesh(8, 1), PARAMS,
                                        pipeline="auto")
        a2, _, _ = run_offline_parallel(frames8, CFG, mesh(8, 1), PARAMS,
                                        pipeline="chunked")
        np.testing.assert_array_equal(a1.numpy(), a2.numpy())
        with pytest.raises(ValueError, match="unknown pipeline"):
            run_offline_parallel(frames8, CFG, mesh(8, 1), pipeline="vmap")

    def test_chunked_rejects_tp_mesh(self):
        with pytest.raises(ValueError, match="DP-only"):
            make_parallel_chunk_step(CFG, mesh(4, 2))
        with pytest.raises(ValueError, match="DP-only"):
            make_engine_parallel_step(
                OrthoModesEngine(CFG, device="cpu"), mesh(4, 2))

    def test_chunk_step_over_shards_equals_one_device(self, frames8):
        """make_parallel_chunk_step on (4, 1) against the one-device
        stream-batched chunk pipeline: equal bit for bit, stereo."""
        cfg = AuralizerConfig(channels=2)
        stepP = make_parallel_chunk_step(cfg, mesh(4, 1))
        one = AuralizerEngine(cfg, device="cpu").raw_chunk_step()
        carry = init_carry_batch(cfg, 8, "cpu")
        cp, op = stepP(carry, frames8, PARAMS)
        cb, ob = one(carry, torch.as_tensor(frames8),
                     sharding._replicated(PARAMS, 8))
        np.testing.assert_array_equal(op["pcm"].numpy(), ob["pcm"].numpy())
        np.testing.assert_array_equal(cp.gather().ola_tail.numpy(),
                                      cb.ola_tail.numpy())

    def test_engine_step_orthomodes_equals_one_device(self):
        """make_engine_parallel_step for OrthoModes on (4, 1): each shard
        through the engine's raw chunk step, equal bit for bit to the
        one-device engine step on all 8 streams."""
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 256, (8, 2, 32, 32, 3), np.uint8)
        eng = OrthoModesEngine(CFG, device="cpu")
        params = eng.params_arrays(LiveParams())
        carry = eng.init_carry_batch(8, frames[0, 0])
        stepP = make_engine_parallel_step(eng, mesh(4, 1), chunk=True)
        cp, op = stepP(carry, frames, params)
        cb, ob = eng.raw_chunk_step()(carry, torch.as_tensor(frames),
                                      sharding._replicated(params, 8))
        np.testing.assert_array_equal(op["pcm"].numpy(), ob["pcm"].numpy())
        np.testing.assert_array_equal(cp.gather().phases.numpy(),
                                      cb.phases.numpy())


class TestOfflineParallel:
    def test_matches_offline_per_stream(self, frames8):
        """The scan pipeline on the (4,2) DP+TP mesh against per-stream
        run_offline (the JAX test's 3e-4); its final hues equal the
        per-frame mesh step's (held to the JAX step in
        TestParallelStep)."""
        audio, final, _ = run_offline_parallel(frames8, CFG, mesh(4, 2),
                                               PARAMS)
        audio = audio.numpy()
        assert audio.shape == (8, 3 * HOP)
        for s in (0, 5):
            ref, _, _ = step.run_offline(frames8[s], CFG, PARAMS,
                                         device="cpu")
            np.testing.assert_allclose(audio[s], ref.numpy(), atol=TP_ATOL)
        carry = init_carry_batch(CFG, 8, "cpu")
        stepP = make_parallel_step(CFG, mesh(4, 2))
        for t in range(3):
            carry, _ = stepP(carry, frames8[:, t], PARAMS)
        np.testing.assert_array_equal(final.gather().hues.numpy(),
                                      carry.gather().hues.numpy())

    def test_output_sharded_over_streams(self, frames8):
        _audio, final, _ = run_offline_parallel(frames8, CFG, mesh(8, 1),
                                                PARAMS)
        assert len(final) == 8 and final.rows == slice(0, 8)
        assert tuple(final.gather().hues.shape) == (8, 16)
        assert all(tuple(part.hues.shape) == (1, 16) for part in final)


class TestMultiHost:
    """The multi-process ingest layer in one process, the code path real
    deployments run with a world of one."""

    def test_local_slice_covers_all_single_process(self):
        m = make_multihost_mesh(devices=CPU8)
        assert m.shape == {"stream": 8, "cell": 1}
        sl = local_stream_slice(m, 16)
        assert (sl.start, sl.stop) == (0, 16)
        with pytest.raises(ValueError, match="divisible"):
            local_stream_slice(m, 9)

    def test_local_slice_of_another_process(self):
        """A process-spanning mesh of two processes seen from rank 0: its
        rows come first, the other process's rows are not its own."""
        m = StreamMesh(np.array([["cpu"]] * 4, dtype=object),
                       processes=[0, 0, 1, 1])
        assert local_stream_slice(m, 8) == slice(0, 4)
        assert m.local_rows == [0, 1]
        other = StreamMesh(np.array([["cpu"]] * 4, dtype=object),
                           processes=[1, 1, 1, 1])
        assert local_stream_slice(other, 8) == slice(0, 0)
        split = StreamMesh(np.array([["cpu"]] * 3, dtype=object),
                           processes=[0, 1, 0])
        with pytest.raises(ValueError, match="not contiguous"):
            local_stream_slice(split, 3)

    def test_distribute_local_frames_sharding(self, frames8):
        m = make_multihost_mesh(devices=CPU8)
        arr = distribute_local_frames(m, frames8, 8)
        assert arr.rows == slice(0, 8) and len(arr) == 8
        assert all(tuple(p.shape) == (1, 3, 64, 64, 3) for p in arr)
        np.testing.assert_array_equal(arr.numpy(), frames8)
        with pytest.raises(ValueError, match="owns"):
            distribute_local_frames(m, frames8[:4], 8)

    def test_multihost_matches_offline(self, frames8):
        mh = MultiHostAuralizer(CFG, n_streams=8, params=PARAMS,
                                mesh=make_multihost_mesh(devices=CPU8))
        assert mh.n_local_streams == 8
        local = mh.local_audio(mh.step(frames8))  # one 3-frame chunk
        assert local.shape == (8, 3 * HOP)
        for s in (0, 7):
            ref, _, _ = chunked.run_offline_batched(frames8[s], CFG, PARAMS,
                                                    chunk=3, device="cpu")
            np.testing.assert_array_equal(local[s], ref.numpy())

    def test_multihost_carry_persists_across_chunks(self, frames8):
        mh = MultiHostAuralizer(CFG, n_streams=8, params=PARAMS,
                                mesh=make_multihost_mesh(devices=CPU8))
        a1 = mh.local_audio(mh.step(frames8))
        a2 = mh.local_audio(mh.step(frames8))
        full, _, _ = chunked.run_offline_batched(
            np.concatenate([frames8[0], frames8[0]]), CFG, PARAMS, chunk=3,
            device="cpu")
        np.testing.assert_array_equal(np.concatenate([a1[0], a2[0]]),
                                      full.numpy())
        step_ref, _, _ = step.run_offline(
            np.concatenate([frames8[0], frames8[0]]), CFG, PARAMS,
            device="cpu")
        np.testing.assert_allclose(np.concatenate([a1[0], a2[0]]),
                                   step_ref.numpy(), atol=TP_ATOL)

    def test_init_distributed_single_process_noop(self):
        assert init_distributed() == 1
        assert init_distributed(num_processes=1) == 1
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="coordinator_address"):
            init_distributed(num_processes=2)

    def test_stereo_multihost(self, frames8):
        cfg = AuralizerConfig(channels=2)
        mh = MultiHostAuralizer(cfg, n_streams=8, params=PARAMS,
                                mesh=make_multihost_mesh(devices=CPU8))
        local = mh.local_audio(mh.step(frames8))
        assert local.shape == (8, 3 * HOP, 2)
        assert np.all(np.isfinite(local))
        with pytest.raises(ValueError, match="DP-only"):
            MultiHostAuralizer(cfg, 8, mesh=mesh(4, 2))


@pytest.mark.parametrize("n", [4, 6])
def test_dryrun_multichip_on_cpu(n, capsys):
    """The dryrun's four paths, one step each, over a repeated CPU device
    (the JAX entry point's odd count too)."""
    ok = dryrun_multichip(n, devices=["cpu"])
    assert len(ok) == 4 and ok[-1] == f"dp{n} MultiHostPod tick"
    line = capsys.readouterr().out
    assert f"{n} shards over 1 device(s), each repeated" in line
