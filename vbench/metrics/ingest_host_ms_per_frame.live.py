"""Host milliseconds a frame inside the program's copies of frames and
live parameters to the card (``vaudio.ingest.*`` spans) on the launching
thread: how long the host is held by ingest, which a pageable copy holds
for its whole length."""

from vbench.spans import INGEST, launcher_seconds, per_frame_ms


def read(trace):
    return per_frame_ms(trace, launcher_seconds(trace, INGEST))
