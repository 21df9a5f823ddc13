"""Plain references of the configurations: one module a reference, named
by a configuration file's ``reference`` key, exporting ``REFERENCE``, a
class built as ``REFERENCE(auralizer, live_params, device, phase_sum=...,
matmul=...)`` whose ``run(frames_of, n)`` returns a stream's PCM,
f32[n, hop, channels] at the configuration's ``channels`` (1 for a mono
family).  A family's reference holds the family's published constants
itself, since the program's API takes none of them.  They import nothing
of the program."""
