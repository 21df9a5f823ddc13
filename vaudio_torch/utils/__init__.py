"""Utilities — the PyTorch port of :mod:`vaudio.utils`, exporting the same
names: tracing and host timers (:mod:`.profiling`, on torch.profiler) and
the display-space helpers (:mod:`.display`).  The debug-surface renderers
(:mod:`.render`), the doctor (:mod:`.doctor`), the f64 literal oracle
(:mod:`.oracles`) and the parity harness and device audit
(:mod:`.parity`) are imported as modules."""

from vaudio_torch.utils.display import peak_shape_curve, spectrum_display
from vaudio_torch.utils.profiling import FrameTimer, trace_context

__all__ = ["FrameTimer", "peak_shape_curve", "spectrum_display",
           "trace_context"]
