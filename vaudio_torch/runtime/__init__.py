"""The per-frame step (:mod:`.step`), the chunk-batched main path
(:mod:`.chunked`) and the serving pod (:mod:`.multistream`,
:class:`MultiStreamAuralizer`: N streams through one batched step a
tick) behind its HTTP panel (:mod:`.podserver`, :class:`PodServer`) —
port of :mod:`vaudio.runtime`."""

from vaudio_torch.runtime.multistream import MultiStreamAuralizer
from vaudio_torch.runtime.podserver import PodServer

__all__ = ["MultiStreamAuralizer", "PodServer"]
