"""Host milliseconds a frame inside the vision stage after its pool
(``vaudio.vision.stats`` spans: K3, or the unfused HSI, histogram,
stencil and statistics stages) on the launching thread."""

from vbench.spans import launcher_seconds, per_frame_ms

SPAN = "vaudio.vision.stats"


def read(trace):
    return per_frame_ms(trace, launcher_seconds(trace, SPAN))
