"""The CUDA kernels K1-K4 against their plain PyTorch versions, the main
path on the card against the CPU, and the live stream on the card against
the offline run on the card.  Needs an NVIDIA GPU and nvcc; every test
skips without a card.  This file imports neither jax nor the JAX package,
so it also runs where they are not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from torch_frames import (k4_args, k4_chained, k4_edge_frames, k4_forms,
                          k4_stream_args, k4_stream_forms, structured_frames,
                          structured_yuv_frames)
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.api import Auralizer
from vaudio_torch.dsp.core import hann_sinc_peak_fast, hann_window_norm
from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                              vision_kernel)
from vaudio_torch.runtime import chunked, step
from vaudio_torch.synth import spectrum
from vaudio_torch.vision import features

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
    plain version's separately rounded multiply and add, bit for bit."""
    frames = torch.as_tensor(gen.integers(0, 256, (T, H, W, 3),
                                          dtype=np.uint8), device=dev)
    planes = frames.permute(0, 3, 1, 2)
    k2 = float(4 ** level)
    assert torch.equal(pool_kernel.mip_pool(frames, level, k2),
                       pool_kernel.mip_pool_plain(planes, level, k2))
    got = pool_kernel.mip_pool(frames, level, 1 / 255.0)
    ref = pool_kernel.mip_pool_plain(planes, level, 1 / 255.0)
    assert got.shape == (T, 3, H >> level, W >> level)
    assert bits_equal(got, ref)


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
    """K1, K2 and K4 on the main path, once a chunk; hues equal, PCM within
    1e-4."""
    cfg = AuralizerConfig(channels=channels)
    frames = structured_frames(0, 12, 192, 256)
    counts = (pool_kernel.launches, spectrum_kernel.launches,
              audio_kernel.launches)
    a_gpu, c_gpu, d_gpu = chunked.run_offline_batched(
        frames, cfg, chunk=8, debug=True, device=dev)
    assert pool_kernel.launches - counts[0] == 2
    assert spectrum_kernel.launches - counts[1] == 2
    assert audio_kernel.launches - counts[2] == 2
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
    pulled PCM equals the offline run on the card; all four kernels launch
    once per frame, or once per chunk (the 2 frames left over after two
    chunks of 4 go frame by frame)."""
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
        assert launched == [4, 4, 4, 4]
        head, carry, _ = chunked.run_offline_batched(frames[:8], cfg,
                                                     chunk=4, device=dev)
        tail, _, _ = step.run_offline(frames[8:], cfg, carry=carry,
                                      device=dev)
        ref = torch.cat([head, tail])
    np.testing.assert_array_equal(got, ref.cpu().numpy().reshape(-1))


def assert_k4_close(got, ref):
    """pcm and tail within 1e-6, the running max within rtol 1e-6: the
    plain version on the card divides by the sigmoid's Python-scalar bound,
    which CUDA turns into a reciprocal multiply, so its norm can be 1 ulp
    from the kernel's true division (the CPU's and the JAX package's)."""
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("nfft", [4096, 8192, 1000])
@pytest.mark.parametrize("T", [1, 8, 64, 300])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("order", ["chunk", "frame", "frames"])
def test_k4_chunk_matches_plain(dev, gen, order, channels, T, nfft):
    """K4 in both op orders (the frame order chained frame by frame, as
    frame_step calls it, and at T frames in one call, as the OrthoModes
    chunk step calls it), mono and stereo, at the live (1, 8) and offline
    (64) T and beyond one block of frames (300), at nfft 4096, above it,
    and at a hop that is not a multiple of 4 (scalar loads): one launch a
    chunk in the chunk order and at T frames, one a frame chained; within
    the band of assert_k4_close of the plain version on the card and of the
    plain version on the CPU."""
    fn, plain, run = k4_forms(order)
    args = k4_args(gen, T, channels, nfft, device=dev)
    before = audio_kernel.launches
    got = run(fn, *args)
    assert audio_kernel.launches == before + (T if order == "frame" else 1)
    assert_k4_close(got, run(plain, *args))
    cpu = run(plain, *(x.cpu() for x in args))
    assert_k4_close([x.cpu() for x in got], cpu)


def sigmoid_normalize_true_division(x, M, k: float = 2.0):
    """dsp.core.sigmoid_normalize with its last divisor a device scalar:
    CUDA divides by it as the CPU and the kernel do, where it multiplies by
    the reciprocal of a Python float."""
    kf = float(np.float32(k))
    scaled = x / M
    g = 1.0 / (1.0 + torch.exp(-kf * (scaled - 0.5)))
    g0 = 1.0 / (1.0 + np.exp(-k * (0.0 - 0.5)))
    g1 = 1.0 / (1.0 + np.exp(-k * (1.0 - 0.5)))
    return (g - float(np.float32(g0))) / torch.tensor(
        np.float32(g1 - g0), device=x.device)


@pytest.mark.parametrize("T", [1, 8, 64])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("order", ["chunk", "frame", "frames"])
def test_k4_is_bit_exact_against_true_division(dev, gen, monkeypatch, order,
                                               channels, T):
    """With the plain versions' one Python-scalar division made a true
    division, the kernel equals them bit for bit: the 1e-6 band of
    assert_k4_close is that division's rounding and nothing else."""
    monkeypatch.setattr(audio_kernel, "sigmoid_normalize",
                        sigmoid_normalize_true_division)
    fn, plain, run = k4_forms(order)
    args = k4_args(gen, T, channels, device=dev)
    got = run(fn, *args)
    ref = run(plain, *args)
    assert all(bits_equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("rmax", [1.0, 0.3, 1e-30, np.inf, np.nan, -1.0])
@pytest.mark.parametrize("order", ["chunk", "frame", "frames"])
def test_k4_edge_frames_match_plain(dev, gen, order, rmax):
    """The edge frames in one chunk (chained in the frame order), after a
    carried running max that is ordinary, tiny, infinite, NaN or negative
    (norm 0): the kernel's one reduction a frame gives the plain version's
    two, NaN where it has NaN (only the running max can be); in one call
    (the chunk order, the frame order at T frames) the chunk equals its
    frames chained one by one, bit for bit."""
    fn, plain, run = k4_forms(order)
    sig = torch.as_tensor(k4_edge_frames(gen), device=dev)
    tail = torch.as_tensor(gen.normal(size=(2, 4096)).astype(np.float32),
                           device=dev)
    window = torch.as_tensor(hann_window_norm(4096), device=dev)
    args = [sig, tail, window] + [
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in (rmax, 0.5, 0.2)]
    got = run(fn, *args)
    assert_k4_close(got, run(plain, *args))
    assert bool(torch.isfinite(got[0]).all())
    if order != "frame":
        assert all(bits_equal(a, b)
                   for a, b in zip(k4_chained(fn, *args), got))


@pytest.mark.parametrize("T", [64, 300])
@pytest.mark.parametrize("channels", [1, 2])
def test_k4_t64_equals_chained_frames_and_itself(dev, gen, channels, T):
    """A T=64 call equals 64 chained T=1 calls and a second call, bit for
    bit; so does a T=300 call, which the kernel takes in two blocks of
    frames."""
    fn = audio_kernel.agc_overlap_add_chunk
    args = k4_args(gen, T, channels, device=dev)
    got = fn(*args)
    assert all(bits_equal(a, b) for a, b in zip(got, fn(*args)))
    assert all(bits_equal(a, b) for a, b in zip(k4_chained(fn, *args), got))


@pytest.mark.parametrize("T", [1, 8, 64])
def test_k4_is_one_launch_per_chunk(dev, gen, T):
    """Under torch.profiler, 10 wrapper calls run only K4's device kernel,
    at most twice a call (the design allows two; it takes one).  The
    profiler can lose device records, never add any, so the count is
    bounded above and each recorded kernel must be K4's."""
    from torch.profiler import ProfilerActivity, profile
    args = k4_args(gen, T, 2, device=dev)
    audio_kernel.agc_overlap_add_chunk(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            audio_kernel.agc_overlap_add_chunk(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 2 * 10
    assert all("agc_overlap_add" in n for n in names), names


def test_k4_chunk_wrapper_checks_inputs(dev):
    z = torch.zeros((2, 4096), device=dev)
    one = torch.ones((), device=dev)
    with pytest.raises(ValueError, match="ola_tail"):
        audio_kernel.agc_overlap_add_chunk(z, z, z[0], one, one, one)
    with pytest.raises(ValueError, match="C = 1 or 2"):
        audio_kernel.agc_overlap_add_chunk(
            torch.zeros((1, 3, 4096), device=dev),
            torch.zeros((3, 4096), device=dev), z[0], one, one, one)


# ---------------------------------------------------------------------------
# K1's planar entry, the YUV path and the config flags on the card
# ---------------------------------------------------------------------------

PLANAR_CASES = ([(64, 1080, 1920, 3), (64, 540, 960, 2), (1, 1080, 1920, 3),
                 (3, 61, 45, 2), (2, 37, 129, 1)]
                + [(2, 257, 389, level) for level in range(1, 8)])


@pytest.mark.parametrize("N,H,W,level", PLANAR_CASES)
def test_k1_planar_matches_plain(dev, gen, N, H, W, level):
    """mip_pool_planes on u8 (N, H, W): the integer block sums exact
    (scale 4^l); the studio-swing scales 1/219 and 1/224 equal to the
    plain version bit for bit."""
    a = torch.as_tensor(gen.integers(0, 256, (N, H, W), dtype=np.uint8),
                        device=dev)
    k = float(4 ** level)
    assert torch.equal(pool_kernel.mip_pool_planes(a, level, k),
                       pool_kernel.mip_pool_plain(a, level, k))
    for scale in (1 / 219.0, 1 / 224.0):
        got = pool_kernel.mip_pool_planes(a, level, scale)
        assert got.shape == (N, H >> level, W >> level)
        assert bits_equal(got, pool_kernel.mip_pool_plain(a, level, scale))


def test_k1_planar_is_batch_independent(dev, gen):
    """Planes 0, N/2 and N-1 of a 64-plane call equal single-plane calls,
    and two calls equal, bit for bit."""
    y = torch.as_tensor(gen.integers(0, 256, (64, 1080, 1920),
                                     dtype=np.uint8), device=dev)
    full = pool_kernel.mip_pool_planes(y, 3, 1 / 219.0)
    assert torch.equal(full, pool_kernel.mip_pool_planes(y, 3, 1 / 219.0))
    for j in (0, 32, 63):
        assert torch.equal(full[j:j + 1], pool_kernel.mip_pool_planes(
            y[j:j + 1].contiguous(), 3, 1 / 219.0))


def test_k1_planar_counts_checks_and_never_runs_plain(dev, monkeypatch):
    """One count per launch; bad inputs raise; on a CUDA tensor neither
    the wrapper nor mip_downsample_planes reaches the plain version."""
    monkeypatch.setattr(pool_kernel, "mip_pool_plain", None)
    y = torch.zeros((2, 64, 64), dtype=torch.uint8, device=dev)
    before = pool_kernel.planar_launches
    pool_kernel.mip_pool_planes(y, 3)
    pool_kernel.mip_pool_planes(y, 2)
    features.mip_downsample_planes(y, 1, scale=1 / 255.0)
    assert pool_kernel.planar_launches - before == 3
    for bad in (y.float(), y[:, :, ::2], y[0, 0]):
        with pytest.raises(ValueError, match="contiguous"):
            pool_kernel.mip_pool_planes(bad, 1)
    with pytest.raises(ValueError, match="does not fit"):
        pool_kernel.mip_pool_planes(y, 7)


def offset_view(x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` bytes into a
    buffer on its device (so its rows are not 16-byte aligned for an odd
    offset)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("H,W,level", [(1079, 1917, 3), (600, 1000, 3),
                                       (64, 37, 1), (257, 389, 7),
                                       (16, 13000, 3), (16, 13008, 3)])
def test_k1_unaligned_rows_match_plain(dev, gen, H, W, level):
    """The interleaved and planar entries on rows that are not 16-byte
    aligned (W and 3 W not multiples of 16, a base 3 bytes into a buffer)
    and on rows wide enough to take several column tiles: equal to the
    plain version bit for bit."""
    frames = torch.as_tensor(gen.integers(0, 256, (2, H, W, 3),
                                          dtype=np.uint8), device=dev)
    planes = frames[..., 1].contiguous()
    for offset in (0, 3):
        f, p = offset_view(frames, offset), offset_view(planes, offset)
        assert bits_equal(pool_kernel.mip_pool(f, level, 1 / 255.0),
                          pool_kernel.mip_pool_plain(f.permute(0, 3, 1, 2),
                                                     level, 1 / 255.0))
        assert bits_equal(pool_kernel.mip_pool_planes(p, level, 1 / 219.0),
                          pool_kernel.mip_pool_plain(p, level, 1 / 219.0))


def yuv_planes(gen, T, H, W, dev, offset=0):
    """u8 Y (T, H, W) and U, V (T, ceil(H / 2), ceil(W / 2)) on ``dev``,
    each ``offset`` bytes into a buffer (:func:`offset_view`)."""
    c = (T, (H + 1) // 2, (W + 1) // 2)
    return [offset_view(torch.as_tensor(gen.integers(
        0, 256, shape, dtype=np.uint8), device=dev), offset)
        for shape in ((T, H, W), c, c)]


YUV_CASES = ([(2, 1080, 1920, 3, True, 0), (1, 1080, 1920, 3, False, 0),
              (2, 600, 1000, 3, True, 0), (2, 600, 1000, 1, False, 0),
              (2, 1080, 1920, 3, True, 5), (2, 16, 13000, 3, True, 0),
              (3, 64, 48, 2, True, 0)]
             + [(3, 1079, 1917, level, True, 0) for level in range(1, 8)])


@pytest.mark.parametrize("T,H,W,level,studio,offset", YUV_CASES)
def test_k1_yuv_matches_plain(dev, gen, T, H, W, level, studio, offset):
    """K1's YUV entry, one launch from the planes to the clamped RGB mips,
    equal bit for bit to its plain version on the card and on the CPU: at
    1080p, on odd crops at every level (at 1 the chroma is not pooled),
    widths whose rows are not 16-byte multiples, a base 5 bytes into a
    buffer, several column tiles (W = 13000), full and studio swing."""
    y, u, v = yuv_planes(gen, T, H, W, dev, offset)
    got = pool_kernel.mip_pool_yuv420(y, u, v, level, studio)
    assert got.shape == (T, 3, H >> level, W >> level)
    assert bits_equal(got, pool_kernel.mip_pool_yuv420_plain(y, u, v, level,
                                                             studio))
    assert bits_equal(got.cpu(), pool_kernel.mip_pool_yuv420(
        y.cpu(), u.cpu(), v.cpu(), level, studio))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_k1_yuv_is_batch_independent(dev, gen):
    """Frames 0, T/2 and T-1 of a 16-frame 1080p call equal T=1 calls (and
    an unbatched (H, W) call), and two calls equal, bit for bit."""
    y, u, v = yuv_planes(gen, 16, 1080, 1920, dev)
    full = pool_kernel.mip_pool_yuv420(y, u, v, 3)
    assert bits_equal(full, pool_kernel.mip_pool_yuv420(y, u, v, 3))
    for j in (0, 8, 15):
        one = pool_kernel.mip_pool_yuv420(
            *(x[j:j + 1].contiguous() for x in (y, u, v)), 3)
        assert bits_equal(one, full[j:j + 1])
    assert bits_equal(pool_kernel.mip_pool_yuv420(y[3], u[3], v[3], 3),
                      full[3])


def k1_counts(before=(0, 0, 0)):
    """K1's launch counts (YUV, planar, interleaved), less ``before``."""
    now = (pool_kernel.yuv_launches, pool_kernel.planar_launches,
           pool_kernel.launches)
    return tuple(a - b for a, b in zip(now, before))


def test_k1_yuv_counts_checks_and_never_runs_plain(dev, monkeypatch):
    """One count a launch, through the wrapper, yuv420_mip_to_rgb_planes
    (mip_level 1 too) and frame_mip_planes, and no other K1 entry; on a
    CUDA tensor no plain version is reached; bad inputs raise."""
    for name in ("mip_pool_plain", "mip_pool_yuv420_plain",
                 "rgb_from_yuv_mips"):
        monkeypatch.setattr(pool_kernel, name, None)
    y = torch.zeros((2, 64, 64), dtype=torch.uint8, device=dev)
    c = torch.zeros((2, 32, 32), dtype=torch.uint8, device=dev)
    before = k1_counts()
    pool_kernel.mip_pool_yuv420(y, c, c, 3)
    features.yuv420_mip_to_rgb_planes(y, c, c, AuralizerConfig(mip_level=1))
    features.frame_mip_planes({"y": y, "u": c, "v": c}, AuralizerConfig())
    assert k1_counts(before) == (3, 0, 0)
    for bad in ((y.float(), c, c), (y, c[:, :, ::2], c), (y[:1], c, c)):
        with pytest.raises(ValueError, match="contiguous"):
            pool_kernel.mip_pool_yuv420(*bad, 3)
    for bad in ((y, c[:, :15].contiguous(), c[:, :15].contiguous()),
                (y, c, c[:, :, :16].contiguous())):
        with pytest.raises(ValueError, match="do not cover"):
            pool_kernel.mip_pool_yuv420(*bad, 3)
    with pytest.raises(ValueError, match="does not fit"):
        pool_kernel.mip_pool_yuv420(y, c, c, 7)


def yuv_head(yuv, start, end):
    return {k: v[start:end] for k, v in yuv.items()}


@pytest.mark.parametrize("channels", [1, 2])
def test_yuv_path_on_the_card_matches_the_cpu(dev, channels):
    """A 256x256 YUV clip (Y 256^2, U and V 128^2), chunked in chunks of 8
    and per frame, on the card against the CPU: hues equal, PCM within
    1e-4; one launch of K1's YUV entry a dispatch, and none of its other
    entries."""
    cfg = AuralizerConfig(channels=channels, use_pallas_vision=True)
    yuv = structured_yuv_frames(20, 12, 256, 256)
    before = k1_counts()
    a_gpu, _, d_gpu = chunked.run_offline_batched(yuv, cfg, chunk=8,
                                                  debug=True, device=dev)
    assert k1_counts(before) == (2, 0, 0)
    a_cpu, _, d_cpu = chunked.run_offline_batched(yuv, cfg, chunk=8,
                                                  debug=True, device="cpu")
    assert torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"])
    assert float((a_gpu.cpu() - a_cpu).abs().max()) <= 1e-4
    head = yuv_head(yuv, 0, 4)
    before = k1_counts()
    a_gpu, _, d_gpu = step.run_offline(head, cfg, debug=True, device=dev)
    assert k1_counts(before) == (4, 0, 0)
    a_cpu, _, d_cpu = step.run_offline(head, cfg, debug=True, device="cpu")
    assert torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"])
    assert float((a_gpu.cpu() - a_cpu).abs().max()) <= 1e-4


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_live_yuv_stream_on_the_card_equals_run_offline(dev, chunk_frames):
    """YUV dict frames streamed on the card with K3 and K4 on: the pulled
    PCM equals the offline run on the card; K1's YUV entry launches once
    a dispatch, its other entries never."""
    cfg = AuralizerConfig(channels=2, use_pallas=True,
                          use_pallas_vision=True, ring_buffer_frames=64)
    yuv = structured_yuv_frames(21, 10, 192, 256)
    frames = [{k: v[i] for k, v in yuv.items()} for i in range(10)]
    before = k1_counts()
    aur = Auralizer(source=frames, config=cfg, device=dev,
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=60)
    assert k1_counts(before) == (aur.metrics["dispatches"], 0, 0)
    got = aur.pull(10 * 2048 * 2)
    if chunk_frames == 1:
        ref, _, _ = step.run_offline(yuv, cfg, device=dev)
    else:
        head, carry, _ = chunked.run_offline_batched(yuv_head(yuv, 0, 8),
                                                     cfg, chunk=4,
                                                     device=dev)
        tail, _, _ = step.run_offline(yuv_head(yuv, 8, 10), cfg,
                                      carry=carry, device=dev)
        ref = torch.cat([head, tail])
    np.testing.assert_array_equal(got, ref.cpu().numpy().reshape(-1))


FLAG_CONFIGS = [dict(quantize_mips=True),
                dict(quantize_mips=True, quantize_mips_int8=True),
                dict(linear_cell_grads=False),
                dict(use_phase_lut=True),
                dict(use_phase_lut=True, use_cumsum_phases=False),
                dict(use_matmul_ema=True), dict(use_matmul_irfft=True)]


@pytest.mark.parametrize("flags", FLAG_CONFIGS)
def test_flag_paths_on_the_card_match_the_cpu(dev, flags):
    """Each flag of the slice on a 256x256 clip, chunked and per frame, on
    the card against the CPU: hues equal, PCM within 1e-4."""
    cfg = AuralizerConfig(channels=2, use_pallas_vision=True, **flags)
    frames = structured_frames(22, 12, 256, 256)
    for run, clip, kw in ((chunked.run_offline_batched, frames,
                           {"chunk": 8}),
                          (step.run_offline, frames[:4], {})):
        a_gpu, _, d_gpu = run(clip, cfg, debug=True, device=dev, **kw)
        a_cpu, _, d_cpu = run(clip, cfg, debug=True, device="cpu", **kw)
        assert torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"])
        assert float((a_gpu.cpu() - a_cpu).abs().max()) <= 1e-4


def test_lut_equals_the_direct_path_on_the_card(dev):
    """The advance table, built on the card with the direct path's ops,
    gathers to the direct advance bit for bit on every hue; the chunked
    prefix-sum run with the LUT equals the default run bit for bit."""
    cfg = AuralizerConfig()
    lut = AuralizerConfig(use_phase_lut=True)
    consts = spectrum.SynthConstants.create(cfg, dev)
    hues = (torch.arange(368, dtype=torch.int32, device=dev) % 360
            ).reshape(23, 16)
    assert torch.equal(spectrum.phase_advance(hues, lut, consts),
                       spectrum.phase_advance(hues, cfg, consts))
    frames = structured_frames(23, 12, 192, 256)
    a, c, _ = chunked.run_offline_batched(frames, cfg, chunk=8, device=dev)
    a_lut, c_lut, _ = chunked.run_offline_batched(frames, lut, chunk=8,
                                                  device=dev)
    assert torch.equal(a_lut, a) and torch.equal(c_lut.phases, c.phases)


def test_debug_surface_on_the_card(dev):
    """sonify(debug=True) on the card: PCM equal to debug=False, the JAX
    shapes; inspect_frame's maps on the card within 1e-6 of the CPU's."""
    cfg = AuralizerConfig(channels=2)
    frames = structured_frames(24, 8, 192, 256)
    aur = Auralizer(config=cfg, device=dev)
    pcm, dbg = aur.sonify(frames, debug=True)
    np.testing.assert_array_equal(pcm, aur.sonify(frames))
    assert dbg["hues"].shape == (8, 16) and dbg["grads"].shape == (8, 16, 4)
    assert dbg["spectrum"].shape == (8, 2, 2047, 2)
    got = aur.inspect_frame(frames[0])
    ref = Auralizer(config=cfg, device="cpu").inspect_frame(frames[0])
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["hues"], ref["hues"])
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=1e-6)


# ---------------------------------------------------------------------------
# The OrthoModes family on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,H,W", [(1, 1080, 1920), (8, 1080, 1920),
                                   (2, 1079, 1917), (3, 190, 250)])
def test_k1_at_the_ortho_level_matches_plain(dev, gen, T, H, W):
    """K1's interleaved entry at mip 5 with the 1/255 scale (the OrthoModes
    route, orthomodes.pixel_mip): equal to the plain version of the
    transposed planes bit for bit, one launch a call."""
    from vaudio_torch.models import orthomodes
    frames = torch.as_tensor(gen.integers(0, 256, (T, H, W, 3),
                                          dtype=np.uint8), device=dev)
    before = pool_kernel.launches
    got = orthomodes.pixel_mip(frames, 5)
    assert pool_kernel.launches == before + 1
    ref = pool_kernel.mip_pool_plain(frames.permute(0, 3, 1, 2), 5,
                                     1 / 255.0)
    assert got.shape == (T, 3, H >> 5, W >> 5) and bits_equal(got, ref)


@pytest.mark.parametrize("T", [8, 64])
@pytest.mark.parametrize("channels", [1, 2])
def test_k4_frames_equal_chained_frame_calls(dev, gen, channels, T):
    """K4's frame order at T frames equals T chained one-frame calls of
    agc_overlap_add and a second call, bit for bit."""
    fn = audio_kernel.agc_overlap_add_frames
    args = k4_args(gen, T, channels, device=dev)
    got = fn(*args)
    assert all(bits_equal(a, b) for a, b in zip(got, fn(*args)))
    chained = k4_chained(k4_forms("frame")[0], *args)
    assert all(bits_equal(a, b) for a, b in zip(chained, got))


def ortho_frames(T=8, H=192, W=256):
    return structured_frames(21, T, H, W)


def test_ortho_steps_on_the_card_match_the_cpu(dev):
    """The OrthoModes frame step and chunk step on the card against the
    port on the CPU: PCM within 1e-4 (the main path's card-vs-CPU band),
    one K1 and one K4 launch a chunk, one of each a frame."""
    from vaudio_torch.models import OrthoModesConfig, OrthoModesModel
    frames = ortho_frames()
    params = OrthoModesModel(device="cpu").default_params()
    pcm = {}
    for where in (dev, torch.device("cpu")):
        model = OrthoModesModel(OrthoModesConfig(), device=where)
        P = model.num_oscillators(192, 256)
        before = (pool_kernel.launches, audio_kernel.launches)
        carry, chunk_pcm, _ = model.chunk_step(model.init_carry(P), frames,
                                               params)
        steps = []
        for frame in frames:
            carry, one = model.frame_step(carry, frame, params)
            steps.append(one)
        after = (pool_kernel.launches - before[0],
                 audio_kernel.launches - before[1])
        assert after == ((9, 9) if where.type == "cuda" else (0, 0))
        pcm[where.type] = torch.cat([chunk_pcm.reshape(-1),
                                     torch.stack(steps).reshape(-1)]).cpu()
    assert bool(torch.isfinite(pcm["cuda"]).all())
    assert float(pcm["cpu"].abs().max()) > 0.1
    torch.testing.assert_close(pcm["cuda"], pcm["cpu"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_ortho_live_stream_on_the_card_equals_offline(dev, chunk_frames):
    """Auralizer(model="orthomodes") streamed on the card: the pulled PCM
    equals the model's steps on the card with the stream's dispatches (10
    frames: per frame, or two chunks of 4 and two single steps), bit for
    bit; K1 and K4 once a dispatch."""
    from vaudio_torch.models import OrthoModesConfig, OrthoModesModel
    frames = ortho_frames(T=10)
    before = (pool_kernel.launches, audio_kernel.launches)
    aur = Auralizer(source=frames, model="orthomodes", device=dev,
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=60)
    aur.raise_if_failed()
    dispatches = aur.metrics["dispatches"]
    assert (pool_kernel.launches - before[0],
            audio_kernel.launches - before[1]) == (dispatches, dispatches)
    got = aur.pull(10 * 2048)
    model = OrthoModesModel(OrthoModesConfig(audio=aur.config), device=dev)
    params = aur._engine.params_arrays(aur.params)
    carry = model.init_carry(model.num_oscillators(192, 256))
    ref = []
    main = 0 if chunk_frames == 1 else 8
    for start in range(0, main, chunk_frames):
        carry, pcm, _ = model.chunk_step(
            carry, frames[start:start + chunk_frames], params)
        ref.append(pcm.reshape(-1))
    for frame in frames[main:]:
        carry, pcm = model.frame_step(carry, frame, params)
        ref.append(pcm)
    np.testing.assert_array_equal(got, torch.cat(ref).cpu().numpy())


# ---------------------------------------------------------------------------
# The serving pod: K4's stream axis and the stream-batched steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,channels,order", [
    (8, 8, 2, "chunk"), (8, 1, 2, "frame"), (2, 8, 1, "frames"),
    (3, 300, 2, "chunk"), (5, 4, 1, "frame")])
def test_k4_stream_axis_matches_plain_and_single_launches(dev, gen, S, T,
                                                          channels, order):
    """K4 on a stream axis (S streams of very different loudness, each its
    own tail and scalars): one launch; within the band of assert_k4_close
    of the plain version (S plain calls); each stream equal bit for bit to
    a launch on that stream alone."""
    fn, plain, frames_of = k4_stream_forms(order)
    sig, tail, window, *scal = k4_stream_args(gen, S, T, channels,
                                              device=dev)
    before = audio_kernel.launches
    got = fn(frames_of(sig), tail, window, *scal)
    assert audio_kernel.launches == before + 1
    assert_k4_close(got, plain(frames_of(sig), tail, window, *scal))
    for s in range(S):
        one = fn(frames_of(sig)[s].contiguous(), tail[s], window,
                 *(x[s] for x in scal))
        assert all(bits_equal(g[s], r) for g, r in zip(got, one))


def test_k4_stream_axis_checks_inputs(dev):
    z = torch.zeros((2, 4, 4096), device=dev)
    tail = torch.zeros((2, 4096), device=dev)
    s2 = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="ola_tail"):
        audio_kernel.agc_overlap_add_chunk(z, tail[:, :2048], tail[0], s2,
                                           s2, s2)
    with pytest.raises(ValueError, match="attack"):
        audio_kernel.agc_overlap_add_chunk(z, tail, tail[0], s2,
                                           torch.ones(3, device=dev), s2)


def pod_run(p, sources):
    p.start([iter(s) for s in sources])
    t0 = time.monotonic()
    while p.is_running:
        assert time.monotonic() - t0 < 120
        time.sleep(0.005)
    p.raise_if_failed()
    return p


@pytest.mark.parametrize("chunk", [1, 4])
def test_pod_on_the_card_equals_single_stream_runs(dev, chunk):
    """The live configuration in a pod of 3 slots (slot 2 ends early) on
    the card: K1, K2, K3 and K4 once a tick; each slot's PCM equal to its
    single-stream run on the card bit for bit per frame, within 2e-6 in
    chunks (batched plain reductions may sum in another order), hues
    equal."""
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import AuralizerEngine
    cfg = AuralizerConfig(channels=2, use_pallas=True,
                          use_pallas_vision=True, ring_buffer_frames=32)
    clips = [structured_frames(30 + s, 8, 192, 256) for s in range(3)]
    clips[2] = clips[2][:5]
    counters = [(pool_kernel, "launches"), (spectrum_kernel, "launches"),
                (vision_kernel, "launches"), (audio_kernel, "launches")]
    before = [getattr(m, a) for m, a in counters]
    p = pod_run(MultiStreamAuralizer(cfg, n_streams=3,
                                     engine=AuralizerEngine(cfg),
                                     chunk_frames=chunk), clips)
    ticks = p.metrics.dispatches
    assert ticks == (8 if chunk == 1 else 2)
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
        == [ticks] * 4
    hues = []
    for s, clip in enumerate(clips):
        got = p.pull(s, len(clip) * 2048 * 2)
        if chunk == 1:
            ref, carry, _ = step.run_offline(clip, cfg, device=dev)
        else:
            ref, carry, _ = chunked.run_offline_batched(clip, cfg,
                                                        chunk=chunk,
                                                        device=dev)
        ref = ref.cpu().numpy().reshape(-1)
        if chunk == 1:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
        hues.append(carry.hues.cpu().numpy())
    np.testing.assert_array_equal(p.snapshot_carry().hues[:2], hues[:2])
    p.stop()


def test_ortho_pod_on_the_card_equals_model_steps(dev):
    """OrthoModes in a pod of 2 slots in chunks of 4 on the card: K1 and K4
    once a tick; each slot equal to the model's chunk steps bit for bit."""
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import OrthoModesEngine
    clips = [ortho_frames(T=8)[::-1].copy(), ortho_frames(T=8)]
    eng = OrthoModesEngine(AuralizerConfig(), device=dev)
    before = (pool_kernel.launches, audio_kernel.launches)
    p = pod_run(MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                     chunk_frames=4), clips)
    assert (pool_kernel.launches - before[0],
            audio_kernel.launches - before[1]) == (2, 2)
    model = eng.model
    params = model.default_params()
    for s, clip in enumerate(clips):
        carry = model.init_carry(model.num_oscillators(192, 256))
        ref = []
        for k in (0, 4):
            carry, pcm, _ = model.chunk_step(carry, clip[k:k + 4], params)
            ref.append(pcm.reshape(-1))
        np.testing.assert_array_equal(p.pull(s, 8 * 2048),
                                      torch.cat(ref).cpu().numpy())
    p.stop()


@pytest.mark.parametrize("NP", [248, 124])
def test_k2_at_a_cell_shards_width_matches_plain(dev, gen, NP):
    """K2 at the TP step's widths, NP = 496/2 and 496/4, T = 2 streams of a
    shard, stereo: within 1e-5 of the plain version."""
    cfg = AuralizerConfig()
    T = 2
    pf = gen.uniform(20, 20000, (T, NP)).astype(np.float32)
    scale = (gen.choice([1.0, 0.2], (T, NP)) / cfg.bin_width
             ).astype(np.float32)
    w = gen.normal(0, 0.1, (T, NP, 4)).astype(np.float32)
    args = [torch.as_tensor(x, device=dev)
            for x in (cfg.bin_frequencies(), pf, scale, w)]
    got = spectrum_kernel.hann_peak_weighted_sum(*args)
    assert got.shape == (T, cfg.num_bins, 4)
    assert float((got - spectrum_kernel.hann_peak_weighted_sum_plain(
        *args)).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_mesh_step_on_the_card_equals_one_device(dev, shape):
    """make_parallel_step over the card's device repeated, the live
    configuration, 4 streams for 3 ticks: DP bit for bit against the
    one-device batched step, TP within 3e-4 (tests/test_parallel.py's
    band), hues equal; K1, K3 and K2 once a shard a tick, K4 once a
    stream row."""
    from vaudio_torch.parallel import (init_carry_batch, make_batched_step,
                                       make_parallel_step, make_stream_mesh)
    cfg = AuralizerConfig(channels=2, use_pallas=True,
                          use_pallas_vision=True)
    params = LiveParams().as_arrays()
    frames = np.stack([structured_frames(40 + s, 3, 192, 256)
                       for s in range(4)])
    n_stream, n_cell = shape
    mesh = make_stream_mesh(n_stream, n_cell,
                            devices=["cuda:0"] * (n_stream * n_cell))
    one, tp = make_batched_step(cfg), make_parallel_step(cfg, mesh)
    carry_1, carry_m = init_carry_batch(cfg, 4), init_carry_batch(cfg, 4)
    counters = [(pool_kernel, "launches"), (vision_kernel, "launches"),
                (spectrum_kernel, "launches"), (audio_kernel, "launches")]
    for t in range(3):
        carry_1, out_1 = one(carry_1, frames[:, t], params)
        before = [getattr(m, a) for m, a in counters]
        carry_m, out_m = tp(carry_m, frames[:, t], params)
        assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
            == [n_stream * n_cell] * 3 + [n_stream]
        ref, got = out_1["pcm"].cpu().numpy(), out_m["pcm"].numpy()
        if n_cell == 1:
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4)
    np.testing.assert_array_equal(carry_m.gather().hues.numpy(),
                                  carry_1.hues.cpu().numpy())
