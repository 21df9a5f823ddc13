"""The CUDA kernels K1 and K2 against their plain PyTorch versions, and the
main path on the card against the CPU.  Needs an NVIDIA GPU and nvcc; every
test skips without a card.  This file imports no jax, so it also runs
where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_frames import structured_frames
from vaudio.config import AuralizerConfig
from vaudio_torch.ops import pool_kernel, spectrum_kernel
from vaudio_torch.runtime import chunked, step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.mark.parametrize("T,H,W,level", [(2, 1080, 1920, 3), (3, 61, 45, 2),
                                         (1, 37, 64, 1), (2, 64, 64, 3)])
def test_k1_matches_plain(dev, gen, T, H, W, level):
    """Integer block sums exact (scale 4^l); the 1/255 output equal to the
    plain version's separately rounded multiply and add, within 1 ulp."""
    frames = torch.as_tensor(gen.integers(0, 256, (T, H, W, 3),
                                          dtype=np.uint8), device=dev)
    planes = frames.permute(0, 3, 1, 2)
    k2 = float(4 ** level)
    assert torch.equal(pool_kernel.mip_pool(frames, level, k2),
                       pool_kernel.mip_pool_plain(planes, level, k2))
    got = pool_kernel.mip_pool(frames, level, 1 / 255.0)
    ref = pool_kernel.mip_pool_plain(planes, level, 1 / 255.0)
    assert got.shape == (T, 3, H >> level, W >> level)
    ulps = (got.view(torch.int32) - ref.view(torch.int32)).abs().max()
    assert int(ulps) <= 1


@pytest.mark.parametrize("K", [2, 4])
def test_k2_matches_plain(dev, gen, K):
    """T=4 at F=2047, NP=496, with partials at bin distances 0, +-1,
    +-0.5, +-2.5: within 1e-5, the contraction band."""
    cfg = AuralizerConfig()
    T, NP = 4, 496
    freqs = cfg.bin_frequencies()
    pf = gen.uniform(20, 20000, (T, NP)).astype(np.float32)
    scale = (gen.choice([1.0, 0.2], (T, NP)) / cfg.bin_width
             ).astype(np.float32)
    scale[:, :7] = 1.0
    pf[:, :7] = freqs[100:107] - np.array([0, 1, -1, 0.5, -0.5, 2.5, -2.5],
                                          np.float32)
    w = gen.normal(0, 0.1, (T, NP, K)).astype(np.float32)
    args = [torch.as_tensor(x, device=dev) for x in (freqs, pf, scale, w)]
    got = spectrum_kernel.hann_peak_weighted_sum(*args)
    ref = spectrum_kernel.hann_peak_weighted_sum_plain(*args)
    assert got.shape == (T, cfg.num_bins, K)
    assert float((got - ref).abs().max()) <= 1e-5


def test_wrappers_count_launches_and_check_inputs(dev):
    frames = torch.zeros((1, 16, 16, 3), dtype=torch.uint8, device=dev)
    before = pool_kernel.launches
    pool_kernel.mip_pool(frames, 3)
    assert pool_kernel.launches == before + 1
    with pytest.raises(ValueError, match="contiguous u8"):
        pool_kernel.mip_pool(frames.float(), 3)
    with pytest.raises(ValueError, match="contiguous f32"):
        spectrum_kernel.hann_peak_weighted_sum(
            torch.zeros(8, device=dev), torch.zeros((1, 4), device=dev),
            torch.zeros((1, 4), device=dev),
            torch.zeros((1, 2, 4), device=dev).transpose(1, 2))


@pytest.mark.parametrize("channels", [1, 2])
def test_chunked_slice_on_the_card_matches_the_cpu(dev, channels):
    """Both kernels on the main path; hues equal, PCM within 1e-4."""
    cfg = AuralizerConfig(channels=channels)
    frames = structured_frames(0, 12, 192, 256)
    counts = (pool_kernel.launches, spectrum_kernel.launches)
    a_gpu, c_gpu, d_gpu = chunked.run_offline_batched(
        frames, cfg, chunk=8, debug=True, device=dev)
    assert pool_kernel.launches - counts[0] == 2
    assert spectrum_kernel.launches - counts[1] == 2
    a_cpu, c_cpu, d_cpu = chunked.run_offline_batched(
        frames, cfg, chunk=8, debug=True, device="cpu")
    assert torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"])
    assert float((a_gpu.cpu() - a_cpu).abs().max()) <= 1e-4
    assert torch.equal(c_gpu.phases.cpu(), c_cpu.phases)


def test_per_frame_step_on_the_card_matches_the_cpu(dev):
    """build_spectrum runs K2 with T=1 once per frame."""
    cfg = AuralizerConfig(channels=2)
    frames = structured_frames(1, 4, 192, 256)
    before = spectrum_kernel.launches
    a_gpu, _, d_gpu = step.run_offline(frames, cfg, debug=True, device=dev)
    assert spectrum_kernel.launches - before == 4
    a_cpu, _, d_cpu = step.run_offline(frames, cfg, debug=True, device="cpu")
    assert torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"])
    assert float((a_gpu.cpu() - a_cpu).abs().max()) <= 1e-4
