"""Device milliseconds of host-to-device copies a frame in the traced
window: the frames' ingest and every other copy to the card."""


def read(trace):
    ms = 1e3 * trace.device_seconds("gpu_memcpy", "HtoD")
    if trace.frames <= 0 or ms <= 0:
        return None
    return ms / trace.frames
