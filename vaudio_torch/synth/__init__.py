"""Spectral synthesis (port of :mod:`vaudio.synth`); see :mod:`.spectrum`."""
