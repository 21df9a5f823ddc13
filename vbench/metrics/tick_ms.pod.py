"""The pod's mean tick in milliseconds: the length of the
``vaudio.pod.tick`` spans (pulling the sources, stacking, copying and
dispatching the batched step, flushing the previous tick) that lie wholly
inside the traced window."""

from vbench.spans import TICK, spans


def read(trace):
    inside = [b - a for _tid, a, b in spans(trace, TICK)
              if a >= 0.0 and b <= trace.window_s]
    if not inside:
        return None
    return 1e3 * sum(inside) / len(inside)
