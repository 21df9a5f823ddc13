"""Kernels, copies and sets on the card a frame in the traced window: the
launches and copies the host dispatches for each frame."""


def read(trace):
    if trace.frames <= 0 or not trace.device:
        return None
    return trace.device_count() / trace.frames
