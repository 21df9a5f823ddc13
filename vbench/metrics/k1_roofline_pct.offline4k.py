"""The mip pool's (K1) share of its roofline (%): its least time over the
traced frames (each frame's u8 pixels read once and its float32 mips
written once, over HBM: ``vbench/pool_counts.py``), over the device time
of its kernels in the trace.  Every frame of the window passes through
the pool once."""

from vbench.pool_counts import k1_bound_s

#: The pool's kernels, by the program's kernel name.
KERNEL = "mip_pool"


def read(trace):
    launches = [d for cat, name, _s, d in trace.device
                if cat == "kernel" and KERNEL in name]
    if not launches or trace.frames <= 0:
        return None
    bound = k1_bound_s(trace.height, trace.width,
                       int(trace.auralizer["mip_level"]), trace.frames)
    return 100.0 * bound / sum(launches)
