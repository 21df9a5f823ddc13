"""Host-side frame sources and PCM sinks the port calls — copies of the
pieces of :mod:`vaudio.io` it needs, so that it never imports the JAX
package."""

from vaudio_torch.io.sinks import write_wav
from vaudio_torch.io.sources import ArraySource, BorrowedFrame, own_frame

__all__ = ["ArraySource", "BorrowedFrame", "own_frame", "write_wav"]
