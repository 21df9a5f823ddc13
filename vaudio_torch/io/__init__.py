"""Host-side frame sources and PCM sinks — the port's copy of
:mod:`vaudio.io`, exporting the same names (plus ``BorrowedFrame`` and
``own_frame``), so that it never imports the JAX package."""

from vaudio_torch.io.push import PushSource
from vaudio_torch.io.sinks import SubprocessPlayer, read_wav, write_wav
from vaudio_torch.io.sources import (VIDEO_FILE_EXTENSIONS, ArraySource,
                                     BorrowedFrame, CameraSource,
                                     Cv2CameraSource, NativeFrameReader,
                                     RawVideoSource, VideoFileSource,
                                     Yuv420FileSource, bgra_to_rgb,
                                     hsb_frames, hsb_to_rgb, own_frame,
                                     parse_yuv420, solid_color_frames,
                                     yuv420_to_rgb)

__all__ = ["VIDEO_FILE_EXTENSIONS", "ArraySource", "BorrowedFrame",
           "CameraSource", "Cv2CameraSource", "NativeFrameReader",
           "PushSource", "RawVideoSource", "SubprocessPlayer",
           "VideoFileSource", "Yuv420FileSource", "bgra_to_rgb",
           "hsb_frames", "hsb_to_rgb", "own_frame", "parse_yuv420",
           "read_wav", "solid_color_frames", "write_wav", "yuv420_to_rgb"]
