"""Multi-process serving pods: one pod whose slots span processes — the
PyTorch port of :mod:`vaudio.parallel.hostpod`.

:class:`vaudio_torch.runtime.multistream.MultiStreamAuralizer` serves N
streams from ONE process; :mod:`vaudio_torch.parallel.multihost` scales the
offline stream axis across processes.  This module serves one pod from
several processes, keeping the reference's per-stream serving semantics
(SoundEngine.swift:171-189 ring contract, per-slot live params
SoundEngine.swift:66-75).

Everything is PROCESS-LOCAL except the lockstep:

* every process constructs the same :class:`MultiHostPod` (same config,
  same ``n_streams`` — the GLOBAL slot count) and owns the slots whose
  mesh rows it drives (:func:`~vaudio_torch.parallel.multihost.
  local_stream_slice`);
* frame ingest, ring buffers, push doors, slot leases, the HTTP panel,
  metrics and checkpoints are per process and cover only the local slots
  — frame bytes and PCM never leave their process;
* each tick every process stacks its local frames and per-slot params and
  runs the engine's raw step on each of its stream shards
  (:mod:`vaudio_torch.parallel.sharding`) — pure DP, no step-time
  collective;
* per-slot :class:`~vaudio_torch.config.LiveParams` survive distribution:
  params are sharded with the streams (each shard reads only its slots'
  values), unlike the single-process mesh pod's one replicated object;
* the only cross-process collectives run on a Gloo group over host
  tensors (:func:`~vaudio_torch.parallel.multihost.host_group`): the
  construction barrier, which also checks that every process agrees on the
  pod, and the per-tick activity sum of :meth:`MultiHostPod._all_inactive`.
  Every process calls it once a producer iteration, so (a) a tick always
  dispatches — idle or exhausted slots ride as masked black frames — and
  (b) all processes see "every source everywhere is exhausted" on the SAME
  tick and their loops end together.

Static capacity: a multi-process pod's capacity is fixed at construction
(scale by adding pods — the fleet layer places across them).
:meth:`acquire_slot` still leases local free slots; it cannot grow past
them.

Lifecycle contract (collective): construction and every producer tick are
collective — run them on every process.  ``stop()`` is cooperative: call
it on every process promptly (a process stopping alone leaves the others'
activity sum waiting until the ``init_distributed`` timeout fails it);
source exhaustion needs no coordination.

Single-process this is the mesh pod over local devices with per-slot
params (what the CPU tests run on ``devices=["cpu"] * n``); the genuinely
multi-process path is pinned by a two-process Gloo test
(``tests/test_torch_hostpod.py``, driving ``tests/torch_hostpod_driver.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from vaudio_torch.config import AuralizerConfig
from vaudio_torch.parallel.multihost import (host_group,
                                             local_stream_slice,
                                             make_multihost_mesh,
                                             process_count)
from vaudio_torch.parallel.sharding import (StreamMesh, _engine_step,
                                            process_index, shard_put)
from vaudio_torch.runtime.multistream import (MultiStreamAuralizer,
                                              _frame_sig, _normalize_frame,
                                              _zeros_like_frame)


class MultiHostPod(MultiStreamAuralizer):
    """A serving pod whose slots span the processes of a multi-process mesh.

    Args:
      cfg: static configuration (identical on every process).
      n_streams: GLOBAL slot count — a multiple of the mesh's 'stream'
        axis.  This process serves only its local share
        (:attr:`local_slice`); every per-slot surface inherited from
        :class:`~vaudio_torch.runtime.multistream.MultiStreamAuralizer`
        (``rings``, ``params``, ``arm_push``, ``acquire_slot``,
        ``stream_metrics``, the panel) indexes LOCAL slots 0..n_local-1.
      frame: an example frame (array or planar-YUV dict — e.g.
        ``np.zeros((h, w, 3), np.uint8)``) fixing the pod's static
        shape/dtype contract up front: processes tick in lockstep from
        tick 0, before any process has necessarily seen a frame.
      mesh: a ('stream',)-or-('stream','cell') mesh spanning all processes
        (default :func:`make_multihost_mesh`).  DP-only: a 'cell' axis must
        be size 1.
      Other arguments match :class:`MultiStreamAuralizer`.  Not supported
        here: ``mesh``-mode shared params (params are per local slot),
        ``idle_shrink``/``max_streams`` (capacity is static), ``resize``.

    Slot re-arms with a carry reset, the cooperative ``stop`` (rings
    cleared, OLA tails zeroed) and the checkpoints (``snapshot_carry``,
    ``save_state``, ``load_state``: this process's rows, one file a
    process, the JAX package's ``.npz`` format) are the base class's,
    applied to the local stream shards.
    """

    def __init__(self, cfg: AuralizerConfig = AuralizerConfig(),
                 n_streams: int = 2, *, frame,
                 mesh: Optional[StreamMesh] = None,
                 params=None, realtime: bool = False,
                 prefer_native: bool = True, chunk_frames: int = 1,
                 exit_when_exhausted: bool = True,
                 metrics_log: Optional[str] = None, engine=None,
                 lease_timeout: Optional[float] = None):
        mesh = mesh if mesh is not None else make_multihost_mesh()
        if "stream" not in mesh.shape:
            raise ValueError("mesh needs a 'stream' axis")
        if mesh.shape.get("cell", 1) != 1:
            raise ValueError(
                "multi-host pods are DP-only ('stream' axis); build the "
                "mesh with n_cell=1 (TP latency mode is single-process: "
                "make_parallel_step)")
        if n_streams % mesh.shape["stream"]:
            raise ValueError(
                f"n_streams {n_streams} not a multiple of the mesh "
                f"stream axis {mesh.shape['stream']}")
        self._gmesh = mesh
        #: GLOBAL slot count (``self.n_streams`` is the LOCAL count).
        self.global_streams = int(n_streams)
        #: Which global slots this process serves.
        self.local_slice = local_stream_slice(mesh, n_streams)
        n_local = self.local_slice.stop - self.local_slice.start
        if n_local == 0:
            raise ValueError(
                "this process owns no mesh devices on the 'stream' axis")
        super().__init__(
            cfg, n_streams=n_local, params=params, realtime=realtime,
            prefer_native=prefer_native, chunk_frames=chunk_frames,
            mesh=None,              # the base mesh mode shares params; ours
            exit_when_exhausted=exit_when_exhausted,  # shards them
            metrics_log=metrics_log, engine=engine,
            max_streams=n_local,    # acquire_slot: lease, never grow
            lease_timeout=lease_timeout)
        # The static frame contract, fixed up front (dark lockstep ticks
        # need a zeros template before any real frame arrives).
        tmpl = _normalize_frame(frame)
        err = self.engine.frame_error(tmpl, self.cfg)
        if err is not None:
            raise ValueError(f"frame template rejected: {err}")
        self._template_sig = _frame_sig(tmpl)
        self._zeros = _zeros_like_frame(tmpl)
        if not self.engine.carry_static:
            # Frame-sized carries initialize eagerly from the template
            # (the single-process pod defers to the first dispatch).
            self._carry = self._shard_put(
                self.engine.init_carry_batch(self.n_streams, tmpl))
            self._carry_checked = True
        self._barrier()

    # -- the process-spanning layout ---------------------------------------

    def _build_step(self):
        """The engine's raw per-frame/per-chunk step on each of this
        process's stream shards, per-slot params sharded with the streams
        — no step-time collective (the DP layout of parallel.sharding)."""
        return _engine_step(self.engine, self._gmesh,
                            chunk=self.chunk_frames > 1, params_sharded=True)

    def _shard_put(self, tree):
        """Local rows (leading axis = n_local) over this process's stream
        shards of the process-spanning mesh."""
        return shard_put(self._gmesh, tree)

    def _barrier(self) -> None:
        """The construction barrier: every process contributes (its stream
        rows, the global slot count, chunk_frames); all must agree, so a
        layout that differs between processes fails here instead of
        wedging a tick."""
        if process_count() == 1:
            return
        import torch.distributed as dist
        mine = torch.tensor([len(self._gmesh.local_rows),
                             self.global_streams, self.chunk_frames])
        every = [torch.zeros_like(mine) for _ in range(process_count())]
        dist.all_gather(every, mine, group=host_group())
        if any(not torch.equal(x, every[0]) for x in every):
            raise ValueError(
                "processes disagree on the pod (stream rows, n_streams, "
                f"chunk_frames): {[x.tolist() for x in every]}")

    # -- lockstep ------------------------------------------------------------

    def _next_batch(self):
        """Always a full batch: every process ticks with the others, so
        when every local slot is dark this process rides the tick with
        masked black frames instead of skipping it."""
        tick = super()._next_batch()
        if tick is None:
            n = self.n_streams
            return [self._zeros] * n, [False] * n
        return tick

    def _all_inactive(self) -> bool:
        """Global exhaustion, decided collectively: every process sums its
        active-slot count on the host group once per producer iteration,
        so every process sees the SAME verdict on the SAME tick and the
        loops end (or idle) together."""
        active = torch.tensor([sum(map(bool, self._active))])
        if process_count() > 1:
            import torch.distributed as dist
            dist.all_reduce(active, group=host_group())
        return int(active) == 0

    # -- capacity is static ------------------------------------------------

    def resize(self, n_streams: int, timeout: float = 30.0) -> None:
        raise RuntimeError(
            "multi-host pods have static capacity: an elastic resize "
            "would need every process to resize together; scale by adding "
            "pods (client.FleetClient places across them) or restart "
            "the pod at the new size")

    def metrics_dict(self) -> Dict[str, object]:
        """Base pod metrics for the LOCAL slots + the global placement
        facts (fleet clients see each process's door as a pod of n_local
        capacity)."""
        out = super().metrics_dict()
        out["global_streams"] = self.global_streams
        out["local_slots"] = list(range(self.local_slice.start,
                                        self.local_slice.stop))
        out["process_index"] = process_index()
        out["process_count"] = process_count()
        return out
