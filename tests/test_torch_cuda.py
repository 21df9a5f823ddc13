"""The CUDA kernels K1-K4 against their plain PyTorch versions, the main
path on the card against the CPU, and the live stream on the card against
the offline run on the card.  Needs an NVIDIA GPU and nvcc; every test
skips without a card.  This file imports neither jax nor the JAX package,
so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_frames import structured_frames
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.api import Auralizer
from vaudio_torch.dsp.core import hann_sinc_peak_fast, hann_window_norm
from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                              vision_kernel)
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


K2_SHAPES = [(T, F, NP, K) for T in (1, 8, 64) for F in (2047, 33)
             for NP in (496, 31, 1024) for K in (2, 4)]
# Bin distances placed at a few bins: the exact limits, half-integers (rint
# rounds them to even) and |d| >= 2^23, where the parity comes from a large
# integer (2^23 + 1 is odd; from 2^24 every float is even, and from 2^31
# the integer conversion saturates).
K2_SPECIAL_D = [0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5]
K2_HUGE_SCALE = [2.0 ** 23 + 1, -(2.0 ** 23 + 1), 2.0 ** 24 + 2, 3.0e9]


def k2_case(gen, T, F, NP, K):
    """f32 (freqs, pf, scale, w) on the host: F bins of the default grid,
    NP partials spread over them, the first ones at the special distances
    (as many as NP takes)."""
    cfg = AuralizerConfig()
    freqs = cfg.bin_frequencies()[:F]
    pf = gen.uniform(freqs[0] - 50, freqs[-1] + 50, (T, NP)).astype(
        np.float32)
    scale = (gen.choice([1.0, 0.2], (T, NP)) / cfg.bin_width).astype(
        np.float32)
    at = [(d, 1.0) for d in K2_SPECIAL_D] + [(1.0, s) for s in K2_HUGE_SCALE]
    for j, (d, s) in enumerate(at[:NP]):
        f = (7 * j + 3) % F
        pf[:, j] = freqs[f] - np.float32(d)
        scale[:, j] = np.float32(s)
    w = gen.normal(0, 0.1, (T, NP, K)).astype(np.float32)
    return freqs, pf, scale, w


@pytest.mark.parametrize("T,F,NP,K", K2_SHAPES)
def test_k2_matches_plain_across_shapes(dev, gen, T, F, NP, K):
    """Within 1e-5 of the plain version (the contraction band) at the
    live, chunked and offline T, a ragged bin tile (F = 33), few and many
    partials, and partials at the special distances."""
    args = [torch.as_tensor(x, device=dev) for x in k2_case(gen, T, F, NP, K)]
    got = spectrum_kernel.hann_peak_weighted_sum(*args)
    ref = spectrum_kernel.hann_peak_weighted_sum_plain(*args)
    assert got.shape == (T, F, K)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5


def test_k2_peak_equals_the_plain_peak(dev, gen):
    """One partial at pf = 0, scale 1 and weight (1, 0, 0, 0): out[0, f, 0]
    is W(freqs[f]) itself, equal to the plain W at every distance: the
    limits, half-integers, 2^23 + 1 (odd), 2^24 and beyond 2^31."""
    d = np.concatenate([
        np.array(K2_SPECIAL_D + K2_HUGE_SCALE + [3.5, -3.5, 4.5, 1e-30,
                                                 2.0 ** 24, -3.0e9]),
        gen.uniform(-40, 40, 200), gen.uniform(-1e6, 1e6, 50)]).astype(
            np.float32)
    freqs = torch.as_tensor(d, device=dev)
    zero = torch.zeros((1, 1), device=dev)
    w = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], device=dev)
    got = spectrum_kernel.hann_peak_weighted_sum(freqs, zero, zero + 1, w)
    assert torch.equal(got[0, :, 0], hann_sinc_peak_fast(freqs))
    assert torch.equal(got[0, :, 0].cpu(), hann_sinc_peak_fast(freqs.cpu()))


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("K", [2, 4])
def test_k2_is_batch_independent_and_deterministic(dev, gen, K):
    """Each frame's output is the same bits at T=1 and inside a batch of
    64, and from run to run."""
    T = 64
    freqs, *rest = (torch.as_tensor(x, device=dev)
                    for x in k2_case(gen, T, 2047, 496, K))
    full = spectrum_kernel.hann_peak_weighted_sum(freqs, *rest)
    assert bits_equal(full, spectrum_kernel.hann_peak_weighted_sum(freqs,
                                                                   *rest))
    for j in (0, 5, T // 2, T - 1):
        one = spectrum_kernel.hann_peak_weighted_sum(
            freqs, *(x[j:j + 1].contiguous() for x in rest))
        assert bits_equal(one[0], full[j])


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


@pytest.mark.parametrize("T", [64, 1])
def test_k3_matches_plain_at_1080p(dev, gen, T):
    """K3 (and K3' at T=1) on random f32 mips of a 1080p frame at mip 3
    (135 x 240), with a dark and a grey band: the HSI is bit-identical to
    the plain version's, so the counts are exact; the statistics within
    atol 1e-6, rtol 1e-5 (another summation order)."""
    cfg = AuralizerConfig()
    mips = gen.uniform(0, 1, (T, 3, 135, 240)).astype(np.float32)
    mips[:, :, :8] = 0.05
    mips[:, :, 8:16] = 0.7
    mips = torch.as_tensor(mips, device=dev)
    before = vision_kernel.launches
    hist, grads = vision_kernel.vision_stats(mips, cfg)
    assert vision_kernel.launches == before + 1
    ref_h, ref_g = vision_kernel.vision_stats_plain(mips, cfg)
    assert hist.shape == (T, 16, 360) and grads.shape == (T, 16, 4)
    assert torch.equal(hist, ref_h)
    assert float(hist.sum()) > 0
    torch.testing.assert_close(grads, ref_g, rtol=1e-5, atol=1e-6)


K3_SHAPES = [(135, 240), (61, 48), (34, 32), (2, 16),
             (2048, 32),         # several row strips per band
             (2, 8192)]          # several column tiles per band


@pytest.mark.parametrize("T", [1, 8, 64])
@pytest.mark.parametrize("hm,wm", K3_SHAPES)
def test_k3_matches_plain_across_shapes(dev, gen, T, hm, wm):
    """Counts exact and statistics within atol 1e-6, rtol 1e-5 at the
    live, chunked and offline T, on mips whose tiles are ragged (61 x 48),
    empty (2 x 16: two of the four row bands hold no pixel), or whose bands
    take several shared-memory tiles."""
    cfg = AuralizerConfig()
    mips = gen.uniform(0, 1, (T, 3, hm, wm)).astype(np.float32)
    if hm >= 16:
        mips[:, :, :hm // 8] = 0.05
        mips[:, :, hm // 8:hm // 4] = 0.7
    mips = torch.as_tensor(mips, device=dev)
    hist, grads = vision_kernel.vision_stats(mips, cfg)
    ref_h, ref_g = vision_kernel.vision_stats_plain(mips, cfg)
    assert hist.shape == (T, 16, 360) and grads.shape == (T, 16, 4)
    assert torch.equal(hist, ref_h)
    assert float(hist.sum()) > 0
    torch.testing.assert_close(grads, ref_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hm,wm", [(135, 240), (61, 48)])
def test_k3_is_batch_independent(dev, gen, hm, wm):
    """Each frame's histogram and statistics are the same bits at T=1 and
    inside a batch of 64."""
    cfg = AuralizerConfig()
    mips = torch.as_tensor(gen.uniform(0, 1, (64, 3, hm, wm)).astype(
        np.float32), device=dev)
    full = vision_kernel.vision_stats(mips, cfg)
    for j in (0, 5, 32, 63):
        one = vision_kernel.vision_stats(mips[j:j + 1].contiguous(), cfg)
        assert bits_equal(one[0][0], full[0][j])
        assert bits_equal(one[1][0], full[1][j])


def test_k3_is_deterministic(dev, gen):
    cfg = AuralizerConfig()
    mips = torch.as_tensor(gen.uniform(0, 1, (8, 3, 135, 240)).astype(
        np.float32), device=dev)
    a = vision_kernel.vision_stats(mips, cfg)
    b = vision_kernel.vision_stats(mips, cfg)
    assert bits_equal(a[0], b[0]) and bits_equal(a[1], b[1])


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rmax,att,rel", [(1.0, 1.0, 1.0), (0.3, 0.5, 0.2),
                                          (2.0, 0.0, 1.0)])
def test_k4_matches_plain(dev, gen, channels, rmax, att, rel):
    """pcm and tail within 1e-6, the running max within rtol 1e-6 (expf on
    the card against the plain version's exp)."""
    shape = (4096,) if channels == 1 else (channels, 4096)
    sig, tail = (torch.as_tensor(gen.normal(size=shape).astype(np.float32),
                                 device=dev) for _ in range(2))
    window = torch.as_tensor(hann_window_norm(4096), device=dev)
    scal = [torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (rmax, att, rel)]
    before = audio_kernel.launches
    got = audio_kernel.agc_overlap_add(sig, tail, window, *scal)
    assert audio_kernel.launches == before + 1
    ref = audio_kernel.agc_overlap_add_plain(sig, tail, window, *scal)
    assert got[0].shape == shape[:-1] + (2048,)
    for g, r in zip(got[:2], ref[:2]):
        assert float((g - r).abs().max()) <= 1e-6
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


def test_k3_k4_wrappers_check_inputs(dev):
    cfg = AuralizerConfig()
    with pytest.raises(ValueError, match="contiguous f32"):
        vision_kernel.vision_stats(torch.zeros((1, 3, 16, 16), device=dev,
                                               dtype=torch.float64), cfg)
    with pytest.raises(ValueError, match="does not take"):
        vision_kernel.vision_stats(torch.zeros((1, 3, 16, 17), device=dev),
                                   cfg)
    z = torch.zeros(4096, device=dev)
    with pytest.raises(ValueError, match="window"):
        audio_kernel.agc_overlap_add(z, z, z[:2048], z[0], z[0], z[0])


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_live_stream_on_the_card_equals_run_offline(dev, chunk_frames):
    """The live configuration (K3 and K4 on) streamed on the card: the
    pulled PCM equals the offline run on the card; per frame all four
    kernels launch, in chunks K1, K2 and K3."""
    cfg = AuralizerConfig(channels=2, use_pallas=True,
                          use_pallas_vision=True, ring_buffer_frames=64)
    frames = structured_frames(3, 10, 192, 256)
    mods = (pool_kernel, spectrum_kernel, vision_kernel, audio_kernel)
    before = [m.launches for m in mods]
    aur = Auralizer(source=frames, config=cfg, device=dev,
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=60)
    launched = [m.launches - b for m, b in zip(mods, before)]
    got = aur.pull(10 * 2048 * 2)
    if chunk_frames == 1:
        assert launched == [10, 10, 10, 10]
        ref, _, _ = step.run_offline(frames, cfg, device=dev)
    else:
        assert launched == [4, 4, 4, 2]
        head, carry, _ = chunked.run_offline_batched(frames[:8], cfg,
                                                     chunk=4, device=dev)
        tail, _, _ = step.run_offline(frames[8:], cfg, carry=carry,
                                      device=dev)
        ref = torch.cat([head, tail])
    np.testing.assert_array_equal(got, ref.cpu().numpy().reshape(-1))
