"""One real step of every multi-device path over n devices — the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

    python -c "from vaudio_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

runs on the card's devices; where the machine has fewer than n cards each
is repeated (a (2, 2) mesh over one card lays four shards on it) and the
printed line says so.  ``devices=["cpu"]`` runs it on the CPU.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> List[str]:
    """Lay an ``n_devices`` mesh over ``devices`` (default every card) and
    run the four multi-device paths, one real step each, on small shapes:

    1. ``make_parallel_step`` — DP ('stream') x TP ('cell', the cell-order
       sum of the synthesis), the latency shape;
    2. ``make_parallel_chunk_step`` — the DP chunk-batched pipeline, the
       throughput shape;
    3. ``make_engine_parallel_step`` — the OrthoModes family on the
       engine-generic DP mesh;
    4. one single-process ``MultiHostPod`` tick — the live serving pod over
       the same mesh (lockstep tick, per-slot params, ring writes).

    Prints one line and returns the paths that ran."""
    from vaudio_torch.config import AuralizerConfig, LiveParams
    from vaudio_torch.parallel import (MultiHostPod, init_carry_batch,
                                       make_engine_parallel_step,
                                       make_parallel_chunk_step,
                                       make_parallel_step, make_stream_mesh)
    from vaudio_torch.parallel.sharding import local_cards, shard_put
    from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine

    devices = list(local_cards() if devices is None else devices)
    have = len(devices)
    devices = [devices[i % have] for i in range(n_devices)]
    where = (f"{n_devices} devices" if have >= n_devices else
             f"{n_devices} shards over {have} device(s), each repeated")

    cfg = AuralizerConfig()
    params = LiveParams().as_arrays()
    rng = np.random.default_rng(0)
    ok = []

    # -- 1. DP x TP per-frame step (latency shape) ---------------------------
    # Factor the device count into (stream, cell): a tensor-parallel axis of
    # 2 whenever possible, the rest data parallel.
    n_cell = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_stream = n_devices // n_cell
    mesh_tp = make_stream_mesh(n_stream, n_cell, devices=devices)
    step = make_parallel_step(cfg, mesh_tp)
    carry = init_carry_batch(cfg, n_stream, "cpu")
    frames = rng.uniform(0, 1, (n_stream, 64, 64, 3)).astype(np.float32)
    _, out = step(carry, frames, params)
    pcm = out["pcm"].numpy()
    assert pcm.shape == (n_stream, cfg.hop_size)
    assert np.all(np.isfinite(pcm))
    ok.append(f"dp{n_stream}xtp{n_cell} frame step")

    # -- 2. chunked-DP pipeline (throughput shape) ---------------------------
    mesh_dp = make_stream_mesh(n_devices, 1, devices=devices)
    T = 2
    cstep = make_parallel_chunk_step(cfg, mesh_dp)
    carry = init_carry_batch(cfg, n_devices, "cpu")
    cframes = rng.uniform(0, 1, (n_devices, T, 64, 64, 3)).astype(np.float32)
    _, out = cstep(carry, cframes, params)
    pcm = out["pcm"].numpy()
    assert pcm.shape == (n_devices, T, cfg.hop_size)
    assert np.all(np.isfinite(pcm))
    ok.append(f"dp{n_devices} chunked step (T={T})")

    # -- 3. second model family on the engine-generic DP mesh ----------------
    eng = OrthoModesEngine(AuralizerConfig(), device=devices[0])
    estep = make_engine_parallel_step(eng, mesh_dp)
    eframe = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    ecarry = shard_put(mesh_dp, eng.init_carry_batch(n_devices, eframe))
    eframes = np.broadcast_to(eframe, (n_devices,) + eframe.shape)
    _, out = estep(ecarry, eframes, eng.params_arrays(LiveParams()))
    pcm = out["pcm"].numpy()
    assert pcm.shape[0] == n_devices and np.all(np.isfinite(pcm))
    ok.append(f"dp{n_devices} orthomodes engine step")

    # -- 4. one MultiHostPod tick (the live serving pod, single-process) -----
    pod = MultiHostPod(cfg, n_devices,
                       frame=np.zeros((32, 32, 3), np.uint8), mesh=mesh_dp,
                       prefer_native=False,
                       engine=AuralizerEngine(cfg, device=devices[0]))
    clip = (rng.uniform(0, 1, (1, 32, 32, 3)) * 255).astype(np.uint8)
    pod.start([iter(clip.copy()) for _ in range(n_devices)])
    t0 = time.monotonic()
    while pod.is_running:
        pod.raise_if_failed()
        if time.monotonic() - t0 > 600:
            pod.stop()
            raise TimeoutError("MultiHostPod tick still running")
        time.sleep(0.005)
    pod.raise_if_failed()
    fill = [pod.stream_metrics(i)["buffer_fill"] for i in range(n_devices)]
    pod.stop()
    assert fill == [1] * n_devices, fill
    ok.append(f"dp{n_devices} MultiHostPod tick")

    print(f"dryrun_multichip: {where}: " + "; ".join(ok), flush=True)
    return ok
