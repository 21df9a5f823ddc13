"""Multi-stream / multi-device parallelism — the PyTorch port of
:mod:`vaudio.parallel`.

* :func:`make_batched_step` — the stream-batched step on one device;
* :func:`make_parallel_step` — the step over a ``('stream', 'cell')``
  :class:`StreamMesh`: data parallelism across streams, plus tensor
  parallelism inside the synthesis (the 16 synthesis cells split over
  ``'cell'`` and their spectra summed in cell order);
* :func:`run_offline_parallel` — the sharded step over a batch of clips;
* :mod:`vaudio_torch.parallel.multihost` — per-process stream ingest for
  meshes that span processes (``torch.distributed`` on Gloo);
* :class:`vaudio_torch.parallel.hostpod.MultiHostPod` — the LIVE serving
  pod over a process-spanning mesh;
* :func:`vaudio_torch.parallel.dryrun.dryrun_multichip` — one real step of
  each path over n devices.

No cross-stream communication exists in the workload, so the ``'stream'``
axis needs no collectives; the ``'cell'`` axis's one reduction is the
model-parallel decomposition of the synthesis contraction.
"""

from vaudio_torch.parallel.hostpod import MultiHostPod
from vaudio_torch.parallel.multihost import (
    MultiHostAuralizer,
    distribute_local_frames,
    init_distributed,
    local_stream_slice,
    make_multihost_mesh,
)
from vaudio_torch.parallel.sharding import (
    StreamMesh,
    init_carry_batch,
    make_batched_step,
    make_engine_parallel_step,
    make_parallel_chunk_step,
    make_parallel_step,
    make_stream_mesh,
    run_offline_parallel,
)

__all__ = [
    "MultiHostAuralizer",
    "MultiHostPod",
    "StreamMesh",
    "distribute_local_frames",
    "init_carry_batch",
    "init_distributed",
    "local_stream_slice",
    "make_batched_step",
    "make_engine_parallel_step",
    "make_multihost_mesh",
    "make_parallel_chunk_step",
    "make_parallel_step",
    "make_stream_mesh",
    "run_offline_parallel",
]
