"""The runtime — the PyTorch port of :mod:`vaudio.runtime`, exporting the
same names: the per-frame step (:mod:`.step`), the chunk-batched main
path (:mod:`.chunked`), checkpoints (:mod:`.checkpoint`), the live
stream's control channel and HTTP server (:mod:`.control`,
:mod:`.server`), and the serving pod (:mod:`.multistream`,
:class:`MultiStreamAuralizer`: N streams through one batched step a tick)
behind its HTTP panel (:mod:`.podserver`, :class:`PodServer`)."""

from vaudio_torch.runtime.checkpoint import load_state, save_state
from vaudio_torch.runtime.chunked import (
    chunk_pipeline,
    make_chunk_pipeline,
    run_offline_batched,
)
from vaudio_torch.runtime.control import ControlChannel, LiveDebugRenderer
from vaudio_torch.runtime.multistream import MultiStreamAuralizer
from vaudio_torch.runtime.podserver import PodServer
from vaudio_torch.runtime.server import LiveServer
from vaudio_torch.runtime.step import (
    StepCarry,
    frame_step,
    init_carry,
    make_step,
    run_offline,
)

__all__ = [
    "ControlChannel",
    "LiveDebugRenderer",
    "LiveServer",
    "MultiStreamAuralizer",
    "PodServer",
    "StepCarry",
    "chunk_pipeline",
    "frame_step",
    "init_carry",
    "load_state",
    "make_chunk_pipeline",
    "make_step",
    "run_offline",
    "run_offline_batched",
    "save_state",
]
