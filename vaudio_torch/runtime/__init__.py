"""The per-frame step (:mod:`.step`) and the chunk-batched main path
(:mod:`.chunked`) — port of :mod:`vaudio.runtime`."""
