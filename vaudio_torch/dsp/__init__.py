"""DSP primitives (port of :mod:`vaudio.dsp`); see :mod:`.core`."""
