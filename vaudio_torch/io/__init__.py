"""Host-side frame sources and PCM sinks the port calls — copies of the
pieces of :mod:`vaudio.io` it needs, so that it never imports the JAX
package."""

from vaudio_torch.io.push import PushSource
from vaudio_torch.io.sinks import write_wav
from vaudio_torch.io.sources import (ArraySource, BorrowedFrame,
                                     CameraSource, NativeFrameReader,
                                     RawVideoSource, Yuv420FileSource,
                                     own_frame, parse_yuv420, yuv420_to_rgb)

__all__ = ["ArraySource", "BorrowedFrame", "CameraSource",
           "NativeFrameReader", "PushSource", "RawVideoSource",
           "Yuv420FileSource", "own_frame", "parse_yuv420", "write_wav",
           "yuv420_to_rgb"]
