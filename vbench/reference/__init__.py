"""Plain references of the configurations: one module a reference, named
by a configuration file's ``reference`` key, exporting ``REFERENCE``, a
class built as ``REFERENCE(auralizer, live_params, device, phase_sum=...,
matmul=...)`` whose ``run(frames_of, n)`` returns a stream's PCM.  They
import nothing of the program."""
