"""The spectrum contraction's (K2) share of its roofline (%): its least
time over the traced frames (the larger of its operations, F NP (27 +
2K) a frame, over the float32 peak and its bytes over HBM), over the
device time of its kernels in the trace.  Every frame of the window
passes through the contraction once."""

from vbench.counts import k2_bound_s

#: The contraction's kernel, by the program's kernel name.
KERNEL = "hann_peak_weighted_sum"


def read(trace):
    launches = [d for cat, name, _s, d in trace.device
                if cat == "kernel" and KERNEL in name]
    if not launches or trace.frames <= 0:
        return None
    bound = k2_bound_s(trace.auralizer, trace.frames, len(launches))
    return 100.0 * bound / sum(launches)
