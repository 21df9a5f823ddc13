"""The device's idle share of the traced window (%): 100 (1 - busy /
window), busy being the union of kernels, copies and sets on the card."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
