"""The bytes of the mip pool (kernel K1) worked out from a frame's shape,
and its least time over HBM at the card's published peak
(:data:`vbench.counts.HBM_BYTES_PER_S`).

A frame's u8 RGB pixels are read once, 3 H W bytes, and its float32 mip
planes written once, 3 (H >> l) (W >> l) 4 bytes: 26,438,400 bytes a
2160x3840 frame at mip 3, 6,609,600 at 1080p.  The pool's few operations
a texel (a block sum and the 1/255 epilogue) lie far under the float32
peak, so bytes bound it.
"""

from __future__ import annotations

from vbench.counts import HBM_BYTES_PER_S


def k1_bytes(height: int, width: int, level: int) -> int:
    """Bytes one frame's pool must move: pixels in, mips out."""
    return 3 * height * width + 3 * (height >> level) * (width >> level) * 4


def k1_bound_s(height: int, width: int, level: int, frames: int) -> float:
    """The pool's least time over ``frames`` frames: their bytes over
    HBM."""
    return frames * k1_bytes(height, width, level) / HBM_BYTES_PER_S
