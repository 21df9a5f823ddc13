"""``latency_p95_ms`` over the window's untraced lead, the stretch before
a traced run's profiler starts (``trace_at`` of the window): the 95th
percentile of the latencies of the frames due in it, on the host's clock.
The whole window's ``latency_p95_ms`` was an end-to-end metric until the
shared host's pace spread it, between runs of one code, by more than half
of the widest bound.  In a traced run the profiler stalls the rest, by
seconds; its warm-up in set-up still costs the lead some speed, so compare
this only between traced runs."""


def read(trace):
    return trace.measures.get("latency_p95_ms.pretrace")
