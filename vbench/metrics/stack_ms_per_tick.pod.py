"""Host milliseconds a pod tick inside the host copy of the tick's frames
into one array (``vaudio.pod.stack`` spans), over the ticks that started
in the traced window."""

from vbench.spans import STACK, all_threads_seconds, ticks_started


def read(trace):
    seconds = all_threads_seconds(trace, STACK)
    ticks = len(ticks_started(trace))
    if seconds is None or ticks == 0:
        return None
    return 1e3 * seconds / ticks
