"""The whole step's share of the card's peak (%): the frames of the traced
window times a frame's least time (the larger of its bytes over HBM and
its operations over the float32 peak), over the window's length."""

from vbench.counts import step_floor_s


def read(trace):
    if trace.frames <= 0 or trace.window_s <= 0:
        return None
    floor = step_floor_s(trace.auralizer, trace.height, trace.width)
    return 100.0 * trace.frames * floor / trace.window_s
