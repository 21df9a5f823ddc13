"""Host milliseconds a frame inside the program's readbacks of PCM
(``vaudio.readback`` spans, on the stream's drain thread): waiting for
the card to finish a step and copying its hop back."""

from vbench.spans import READBACK, all_threads_seconds, per_frame_ms


def read(trace):
    return per_frame_ms(trace, all_threads_seconds(trace, READBACK))
