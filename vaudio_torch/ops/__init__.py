"""The hand-written CUDA kernels and their plain PyTorch versions — the
PyTorch port of :mod:`vaudio.ops`.  Each entry runs its kernel on a CUDA
tensor and its plain version on a CPU tensor:

* K1 :mod:`.pool_kernel`: :func:`mip_pool` (interleaved u8 RGB frames),
  :func:`mip_pool_planes` (u8 planes) and :func:`mip_pool_yuv420` (planar
  YUV 4:2:0 to RGB mips);
* K2 :mod:`.spectrum_kernel`: :func:`hann_peak_weighted_sum` (T frames);
* K3 :mod:`.vision_kernel`: :func:`vision_stats`;
* K4 :mod:`.audio_kernel`: :func:`agc_overlap_add` (one frame),
  :func:`agc_overlap_add_frames` (T frames in the frame order) and
  :func:`agc_overlap_add_chunk` (T frames in the chunk order).

The JAX package's TPU kernel names have no alias here, since they name a
backend the port does not have.  Their counterparts:

* ``mip_pool_pallas`` -> :func:`mip_pool`;
* ``hann_peak_weighted_sum_batched`` -> :func:`hann_peak_weighted_sum`
  with a leading T;
* ``spectrum_pallas`` -> :func:`vaudio_torch.synth.spectrum.contract_spectrum`;
* ``vision_stats_pallas`` -> :func:`vision_stats`.

Importing this package builds nothing: the kernels are built at their
first launch (:mod:`._build`).
"""

from vaudio_torch.ops.audio_kernel import (agc_overlap_add,
                                           agc_overlap_add_chunk,
                                           agc_overlap_add_frames)
from vaudio_torch.ops.pool_kernel import (mip_pool, mip_pool_planes,
                                          mip_pool_yuv420)
from vaudio_torch.ops.spectrum_kernel import hann_peak_weighted_sum
from vaudio_torch.ops.vision_kernel import vision_stats

__all__ = ["agc_overlap_add", "agc_overlap_add_chunk",
           "agc_overlap_add_frames", "hann_peak_weighted_sum", "mip_pool",
           "mip_pool_planes", "mip_pool_yuv420", "vision_stats"]
