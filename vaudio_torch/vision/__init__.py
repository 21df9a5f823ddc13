"""Frame feature extraction (port of :mod:`vaudio.vision`); see
:mod:`.features`."""
