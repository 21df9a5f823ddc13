"""The per-frame step (:mod:`.step`), the chunk-batched main path
(:mod:`.chunked`) and the serving pod (:mod:`.multistream`,
:class:`MultiStreamAuralizer`: N streams through one batched step a
tick) — port of :mod:`vaudio.runtime`."""

from vaudio_torch.runtime.multistream import MultiStreamAuralizer

__all__ = ["MultiStreamAuralizer"]
