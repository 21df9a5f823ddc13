"""``frames_per_s`` over the window's untraced lead, the stretch before a
traced run's profiler starts (``trace_at`` of the window): the frames
completed in it over its length, on the host's clock.  The whole window's
``frames_per_s`` was an end-to-end metric until the shared host's pace
spread it, between runs of one code, by more than half of the widest
bound.  In a traced run the profiler slows the rest; its warm-up in set-up
still costs the lead some speed, so compare this only between traced
runs."""


def read(trace):
    return trace.measures.get("frames_per_s.pretrace")
