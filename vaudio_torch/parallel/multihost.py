"""Multi-process ingest: scale the stream axis across processes — the
PyTorch port of :mod:`vaudio.parallel.multihost`.

The reference is a single-process app fed by one camera
(video-auralizer/CameraModel.swift:12-37); its only scale axis is "more
streams" (SURVEY.md §5: the pipeline is embarrassingly parallel per
stream).  Across processes that axis maps onto ranks: every process
captures or decodes its OWN streams and feeds only the mesh rows its local
devices hold, so frame bytes never leave their process.  Layout rules:

* the ``'stream'`` mesh axis spans processes, process-major
  (:func:`make_multihost_mesh`): pure data parallelism, zero collectives at
  step time;
* the ``'cell'`` axis stays inside a process.

JAX assembles one global array from the processes' pieces; PyTorch has no
global array, so the front door :func:`distribute_local_frames` returns
the process's own rows placed on its stream shards, tagged with their
global row range (:class:`~vaudio_torch.parallel.sharding.StreamShards`).

Processes meet through ``torch.distributed`` on a Gloo group over host
tensors (:func:`init_distributed`): the only collectives are the serving
pod's construction barrier and its per-tick activity sum
(:mod:`vaudio_torch.parallel.hostpod`).  Gloo takes two ranks on one card,
which NCCL refuses, and a host flag needs no device synchronisation.
Everything degrades to a single process, the code path the CPU tests run.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import numpy as np

from vaudio_torch.config import AuralizerConfig
from vaudio_torch.parallel.sharding import (StreamMesh, StreamShards,
                                            _leading, init_carry_batch,
                                            local_cards,
                                            make_parallel_chunk_step,
                                            process_index, shard_put)
from vaudio_torch.runtime.step import default_params

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_host_group = None


def process_count() -> int:
    """The world size of ``torch.distributed`` (1 when it is not
    initialized)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = 300.0) -> int:
    """Join the processes of a multi-process run (call ONCE on every
    process, before any collective): ``torch.distributed`` with the Gloo
    backend at ``tcp://<coordinator_address>`` (``host:port``), with
    ``num_processes`` ranks of which this is ``process_id``.  A collective
    that some rank never reaches fails after ``timeout`` seconds instead of
    hanging.  No-op for a single process or an initialized runtime.

    With all three arguments ``None`` the environment decides: torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` join it,
    and without them this is the single-process no-op.  Returns the
    process count."""
    import torch.distributed as dist
    wait = datetime.timedelta(seconds=timeout)
    if dist.is_initialized():
        pass
    elif num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group("gloo", init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=wait)
    elif (num_processes is None and process_id is None
          and coordinator_address is None
          and all(k in os.environ for k in _ENV)):
        dist.init_process_group("gloo", init_method="env://", timeout=wait)
    return process_count()


def host_group():
    """The Gloo group of the host-side collectives: the default group when
    it is Gloo, else one Gloo group over every rank, made on the first call
    (a collective call: every rank makes it at the same point)."""
    global _host_group
    import torch.distributed as dist
    if dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def make_multihost_mesh(n_cell: int = 1, devices=None) -> StreamMesh:
    """A ('stream', 'cell') mesh over ALL processes' devices, process-major:
    each process's ``devices`` (default every card it sees) are contiguous
    along 'stream', so the 'cell' axis stays inside a process.  Every
    process must pass the same number of local devices (the serving pod's
    construction barrier checks the layout); another process's rows carry
    this process's device names as stand-ins — a process only ever touches
    its own rows."""
    devices = list(local_cards() if devices is None else devices)
    if len(devices) % n_cell:
        raise ValueError(f"{len(devices)} local devices do not split into "
                         f"cell groups of {n_cell}")
    rows = len(devices) // n_cell
    world = process_count()
    grid = np.empty(world * len(devices), dtype=object)
    grid[:] = devices * world
    return StreamMesh(grid.reshape(world * rows, n_cell),
                      processes=np.repeat(np.arange(world), rows))


def local_stream_slice(mesh: StreamMesh, n_streams: int) -> slice:
    """Which global stream indices THIS process must feed.

    Streams are block-distributed over the 'stream' axis; a process owns
    the rows its devices hold.  n_streams must be a multiple of the
    stream-axis size."""
    n_stream_shards = mesh.shape["stream"]
    if n_streams % n_stream_shards:
        raise ValueError(f"n_streams {n_streams} not divisible by "
                         f"stream-axis size {n_stream_shards}")
    per_shard = n_streams // n_stream_shards
    mine = mesh.local_rows
    if not mine:
        return slice(0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            "process's stream rows are not contiguous; build the mesh with "
            "make_multihost_mesh so 'stream' is the process-major axis")
    return slice(mine[0] * per_shard, (mine[-1] + 1) * per_shard)


def distribute_local_frames(mesh: StreamMesh, local_frames,
                            n_streams: int) -> StreamShards:
    """Place THIS process's frames on its stream shards.

    Args:
      mesh: the ('stream', 'cell') mesh.
      local_frames: (S_local, T, ...) — the frames of the streams this
        process owns (:func:`local_stream_slice`), an array or a dict of
        planes.  They go straight to the process's own devices.
      n_streams: global stream count.
    Returns:
      :class:`StreamShards` of the local rows, ``rows`` their global
      range."""
    expect = local_stream_slice(mesh, n_streams)
    n_local = expect.stop - expect.start
    got = _leading(local_frames)
    if got != n_local:
        raise ValueError(
            f"this process owns {n_local} streams "
            f"(global rows {expect.start}:{expect.stop}), got {got}")
    return shard_put(mesh, local_frames)


class MultiHostAuralizer:
    """Chunk-at-a-time multi-process sonification driver.

    Each process constructs one of these (same config, same n_streams) and
    repeatedly calls :meth:`step` with ITS streams' next T frames.  The DP
    step needs no communication, so processes may step at their own pace.
    PCM for the local streams comes back with :meth:`local_audio`.

    Single-process this is the DP-chunked mesh pipeline
    (parallel.make_parallel_chunk_step) with explicit ingest plumbing —
    which is what the CPU tests run."""

    def __init__(self, cfg: AuralizerConfig, n_streams: int,
                 mesh: Optional[StreamMesh] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_multihost_mesh()
        if self.mesh.shape.get("cell", 1) != 1:
            raise ValueError("MultiHostAuralizer is DP-only (n_cell=1); "
                             "use make_parallel_step for TP")
        self.n_streams = n_streams
        self.params = params if params is not None else default_params(cfg)
        self._step = make_parallel_chunk_step(cfg, self.mesh)
        self.local_slice = local_stream_slice(self.mesh, n_streams)
        self.carry = shard_put(
            self.mesh, init_carry_batch(cfg, self.n_local_streams, "cpu"))

    @property
    def n_local_streams(self) -> int:
        return self.local_slice.stop - self.local_slice.start

    def step(self, local_frames) -> StreamShards:
        """Run one T-frame chunk of this process's streams; returns their
        pcm (n_local, T, hop[, ch]) as :class:`StreamShards` on the
        shards' devices."""
        frames = distribute_local_frames(self.mesh, local_frames,
                                         self.n_streams)
        self.carry, out = self._step(self.carry, frames, self.params)
        return out["pcm"]

    def local_audio(self, pcm: StreamShards) -> np.ndarray:
        """THIS process's streams' PCM in host memory:
        (S_local, T*hop) mono or (S_local, T*hop, ch)."""
        local = pcm.gather("cpu").numpy()
        T, hop = local.shape[1], local.shape[2]
        if self.cfg.channels == 1:
            return local.reshape(local.shape[0], T * hop)
        return local.reshape(local.shape[0], T * hop, self.cfg.channels)

