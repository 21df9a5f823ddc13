"""Host milliseconds a frame inside the vision stage's mip pool
(``vaudio.vision.pool`` spans: the launch of K1 on the card) on the
launching thread."""

from vbench.spans import launcher_seconds, per_frame_ms

SPAN = "vaudio.vision.pool"


def read(trace):
    return per_frame_ms(trace, launcher_seconds(trace, SPAN))
