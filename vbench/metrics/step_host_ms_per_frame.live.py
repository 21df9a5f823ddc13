"""Host milliseconds a frame inside the runtime step (``vaudio.step``
spans: the host dispatch of the vision, synthesis and audio stages) on
the launching thread, less the part its copies (``vaudio.ingest.*``)
cover."""

from vbench.spans import per_frame_ms, step_seconds


def read(trace):
    return per_frame_ms(trace, step_seconds(trace))
