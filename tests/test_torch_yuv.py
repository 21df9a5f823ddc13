"""Planar YUV 4:2:0 ingest in the port against the JAX package on the same
numpy inputs: kernel K1's planar and YUV entries (their plain versions
here), the YUV mips, the host io (conversion, parsing, raw-video
sources), and YUV clips through every path: chunked, per frame, blocked,
the live stream per frame and in chunks, and ``Auralizer.sonify``.

Bands: the planar pool, the YUV -> RGB mips (against EAGER JAX calls) and
the io are exact.  The pipelines are held to hues equal and PCM within
2e-5, on clips whose hue sequence has no EMA tie
(``tests/torch_frames.py::structured_yuv_frames``): under jit XLA:CPU may
contract ``my + 1.402 mv`` and its siblings into FMAs, an ulp from the
eager ops the port computes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vaudio.io.sources as jax_sources
import vaudio.runtime.chunked as jax_chunked
import vaudio.runtime.step as jax_step
from torch_frames import (rgb_to_yuv420, structured_frames,
                          structured_yuv_frames, yuv420_bytes)
from vaudio.ops.pool_kernel import mip_pool_pallas
from vaudio.runtime.stream import StreamingAuralizer as JaxStream
from vaudio.vision import features as jf
from vaudio_torch import io as tio
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.ops import pool_kernel
from vaudio_torch.runtime import chunked, step
from vaudio_torch.vision import features as tf

CFG = AuralizerConfig()
PARAMS = LiveParams().as_arrays()
PCM_ATOL = 2e-5          # the JAX package's chunked band (test_chunked.py:20)


def t(x):
    return torch.as_tensor(np.array(x))


def random_yuv(rng, T, H, W):
    return {"y": rng.integers(0, 256, (T, H, W), dtype=np.uint8),
            "u": rng.integers(0, 256, (T, H // 2, W // 2), dtype=np.uint8),
            "v": rng.integers(0, 256, (T, H // 2, W // 2), dtype=np.uint8)}


def assert_runs_agree(ref, got):
    """Hues equal, PCM within 2e-5, phases bit for bit."""
    (a_ref, c_ref, d_ref), (a_got, c_got, d_got) = ref, got
    np.testing.assert_array_equal(d_got["hues"].numpy(),
                                  np.asarray(d_ref["hues"]))
    assert a_got.shape == np.asarray(a_ref).shape
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                               atol=PCM_ATOL)
    np.testing.assert_array_equal(c_got.phases.numpy(),
                                  np.asarray(c_ref.phases))


# ---------------------------------------------------------------------------
# K1's planar entry and the YUV mips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,level", [((64, 64), 3), ((61, 45), 2),
                                         ((32, 48), 1), ((129, 130), 7)])
def test_planar_pool_matches_the_pallas_kernel(rng, shape, level):
    """mip_pool_planes (its plain version on the CPU) against the TPU
    kernel's own form, mip_pool_pallas on u8 [C, H, W] in interpret mode,
    and the eager u8 path of the JAX mip_downsample_planes: the integer
    sums (scale 4^l) exact against both; at the studio-swing scales exact
    against the eager path (one rounded multiply, one rounded add) and
    within an ulp of the largest output, 255 scale, of the kernel (whose
    multiply-add may be one FMA)."""
    planes = rng.integers(0, 256, (2,) + shape, dtype=np.uint8)
    for scale in (float(4 ** level), 1 / 219.0, 1 / 224.0):
        kernel = np.asarray(mip_pool_pallas(jnp.asarray(planes), level,
                                            scale=scale, interpret=True))
        eager = np.asarray(jf.mip_downsample_planes(jnp.asarray(planes),
                                                    level, scale=scale))
        got = pool_kernel.mip_pool_planes(t(planes), level, scale).numpy()
        np.testing.assert_array_equal(got, eager)
        atol = 0.0 if scale > 1 else np.spacing(np.float32(255 * scale))
        np.testing.assert_allclose(got, kernel, rtol=0, atol=atol)


@pytest.mark.parametrize("H,W,level,studio", [
    (64, 64, 3, True), (62, 46, 3, True), (64, 96, 1, True),
    (64, 64, 2, False), (96, 128, 4, True)])
def test_yuv_mips_equal_eager_jax(rng, H, W, level, studio):
    """yuv420_mip_to_rgb_planes, batched over T, against the eager JAX
    function frame by frame: bit for bit (the separate offset adds, the
    crop of the chroma mips, BT.601 as separate ops, the clip)."""
    cfg = dataclasses.replace(CFG, mip_level=level)
    yuv = random_yuv(rng, 3, H, W)
    got = tf.yuv420_mip_to_rgb_planes(t(yuv["y"]), t(yuv["u"]), t(yuv["v"]),
                                      cfg, studio_swing=studio).numpy()
    for k in range(3):
        ref = jf.yuv420_mip_to_rgb_planes(
            jnp.asarray(yuv["y"][k]), jnp.asarray(yuv["u"][k]),
            jnp.asarray(yuv["v"][k]), cfg, studio_swing=studio)
        np.testing.assert_array_equal(got[k], np.asarray(ref))


@pytest.mark.parametrize("H,W,level,studio", [
    (64, 64, 3, True), (62, 46, 3, True), (64, 96, 1, True),
    (64, 64, 2, False), (96, 128, 4, True), (64, 96, 1, False),
    (130, 258, 7, True), (129, 300, 7, False)])
def test_fused_yuv_plain_equals_eager_jax(rng, H, W, level, studio):
    """K1's YUV entry's plain version, mip_pool_yuv420_plain, against the
    eager JAX yuv420_mip_to_rgb_planes frame by frame, bit for bit: at
    mip_level 1 the chroma is not pooled (v * scale, not the epilogue's
    (v - 128) scale + 128 scale), at 7 the chroma pools at 6."""
    yuv = random_yuv(rng, 2, H, W)
    got = pool_kernel.mip_pool_yuv420_plain(
        t(yuv["y"]), t(yuv["u"]), t(yuv["v"]), level, studio).numpy()
    assert got.shape == (2, 3, H >> level, W >> level)
    cfg = dataclasses.replace(CFG, mip_level=level)
    for k in range(2):
        ref = jf.yuv420_mip_to_rgb_planes(
            jnp.asarray(yuv["y"][k]), jnp.asarray(yuv["u"][k]),
            jnp.asarray(yuv["v"][k]), cfg, studio_swing=studio)
        np.testing.assert_array_equal(got[k], np.asarray(ref))


def test_frame_mip_planes_of_a_dict_equal_eager_jax(rng):
    """The dict branch of frame_mip_planes, and the chroma at level 0 (no
    pool: convert and scale) with mip_level 1: bit for bit."""
    for level in (1, 3):
        cfg = dataclasses.replace(CFG, mip_level=level)
        yuv = random_yuv(rng, 2, 48, 64)
        got = tf.frame_mip_planes({k: t(v) for k, v in yuv.items()}, cfg)
        for k in range(2):
            ref = jf.frame_mip_planes({p: v[k] for p, v in yuv.items()}, cfg)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref))


def test_yuv_needs_a_mip_level(rng):
    yuv = {k: t(v) for k, v in random_yuv(rng, 1, 16, 16).items()}
    with pytest.raises(ValueError, match="mip_level >= 1"):
        tf.frame_mip_planes(yuv, dataclasses.replace(CFG, mip_level=0))


def test_the_yuv_mips_route_through_the_planar_entry(rng, monkeypatch):
    """One call of K1's YUV entry a dispatch, at every mip level K1 takes
    (at 1 too, where the chroma is not pooled), and none of the planar or
    interleaved entries; the planes reach it as they came."""
    calls = []
    fused = pool_kernel.mip_pool_yuv420

    def counting(y, u, v, level, studio_swing=True):
        calls.append((tuple(y.shape), tuple(u.shape), level, studio_swing))
        return fused(y, u, v, level, studio_swing)

    def never(*args, **kwargs):
        raise AssertionError("a YUV dispatch reached another K1 entry")

    monkeypatch.setattr(pool_kernel, "mip_pool_yuv420", counting)
    monkeypatch.setattr(pool_kernel, "mip_pool_planes", never)
    monkeypatch.setattr(pool_kernel, "mip_pool", never)
    yuv = {k: t(v) for k, v in random_yuv(rng, 4, 64, 64).items()}
    for level in (3, 1):
        calls.clear()
        mips = tf.frame_mip_planes(yuv, dataclasses.replace(
            CFG, mip_level=level))
        assert calls == [((4, 64, 64), (4, 32, 32), level, True)]
        assert mips.shape == (4, 3, 64 >> level, 64 >> level)


# ---------------------------------------------------------------------------
# Host io: conversion, parsing, raw-video sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("studio", [True, False])
def test_yuv420_to_rgb_equals_jax(rng, studio):
    yuv = random_yuv(rng, 1, 16, 24)
    planes = [yuv[k][0] for k in "yuv"]
    np.testing.assert_array_equal(
        tio.yuv420_to_rgb(*planes, studio_swing=studio),
        jax_sources.yuv420_to_rgb(*planes, studio_swing=studio))
    full = [yuv["y"][0]] + [np.repeat(np.repeat(p, 2, 0), 2, 1)
                            for p in planes[1:]]
    np.testing.assert_array_equal(tio.yuv420_to_rgb(*full),
                                  jax_sources.yuv420_to_rgb(*full))


@pytest.mark.parametrize("fmt", ["i420", "nv12"])
def test_parse_yuv420_equals_jax(rng, fmt):
    yuv = random_yuv(rng, 1, 8, 12)
    buf = yuv420_bytes(yuv, 0, fmt)
    got = tio.parse_yuv420(buf, 8, 12, fmt)
    ref = jax_sources.parse_yuv420(buf, 8, 12, fmt)
    for g, r, k in zip(got, ref, "yuv"):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, yuv[k][0])


@pytest.mark.parametrize("fmt,raw", [("i420", True), ("nv12", True),
                                     ("i420", False), ("nv12", False)])
def test_yuv_file_source_equals_jax(rng, tmp_path, fmt, raw):
    """Yuv420FileSource and RawVideoSource read what the JAX package's
    read (its Python reader, native=False): raw dicts or converted RGB."""
    yuv = random_yuv(rng, 3, 16, 16)
    path = tmp_path / f"clip.{fmt}"
    path.write_bytes(b"".join(yuv420_bytes(yuv, k, fmt) for k in range(3)))
    got = list(tio.Yuv420FileSource(str(path), 16, 16, raw=raw,
                                    fmt=fmt).frames())
    ref = list(jax_sources.RawVideoSource(str(path), 16, 16, pix_fmt=fmt,
                                          raw=raw, native=False).frames())
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        if raw:
            assert set(g) == {"y", "u", "v"}
            for k in "yuv":
                np.testing.assert_array_equal(g[k], r[k])
        else:
            np.testing.assert_array_equal(g, r)
    two = list(tio.RawVideoSource(str(path), 16, 16, pix_fmt=fmt, raw=raw,
                                  max_frames=2).frames())
    assert len(two) == 2


def test_camera_source_defaults_and_the_native_reader(tmp_path):
    """CameraSource: NV12 1080p planar dicts by default; rgb24 frames, read
    by the Python loop and by the native reader (zero-copy too; more in
    tests/test_torch_native.py)."""
    cam = tio.CameraSource(str(tmp_path / "none"))
    assert (cam.shape, cam.pix_fmt, cam.raw) == ((1080, 1920), "nv12", True)
    frames = np.arange(2 * 4 * 6 * 3, dtype=np.uint8).reshape(2, 4, 6, 3)
    path = tmp_path / "clip.rgb"
    path.write_bytes(frames.tobytes())
    got = list(tio.RawVideoSource(str(path), 6, 4).frames())
    np.testing.assert_array_equal(np.stack(got), frames)
    for zero_copy in (False, True):
        got = [np.array(f) for f in tio.RawVideoSource(
            str(path), 6, 4, native=True, zero_copy=zero_copy).frames()]
        np.testing.assert_array_equal(np.stack(got), frames)
    with pytest.raises(ValueError, match="YUV pix_fmt"):
        tio.RawVideoSource(str(path), 6, 4, raw=True)


def test_the_rgb_to_yuv_helper_round_trips(rng):
    """tests/torch_frames.py's BT.601 converter against the host inverse
    on colour constant over each 2x2 block: within 2 u8 steps (the
    rounding in both directions), studio and full swing."""
    frames = np.repeat(np.repeat(rng.integers(30, 226, (2, 8, 8, 3)), 2, 1),
                       2, 2).astype(np.uint8)
    for studio in (True, False):
        yuv = rgb_to_yuv420(frames, studio_swing=studio)
        back = np.stack([tio.yuv420_to_rgb(*(yuv[k][i] for k in "yuv"),
                                           studio_swing=studio)
                         for i in range(2)])
        assert np.abs(back.astype(int) - frames).max() <= 2


# ---------------------------------------------------------------------------
# YUV clips through the pipelines
# ---------------------------------------------------------------------------

def test_the_yuv_clip_has_no_hue_ema_tie():
    """structured_yuv_frames: the JAX hues move, and no step of the 0.9 /
    0.1 EMA lands on an exact integer (the FMA trap of the jitted
    pipelines)."""
    yuv = structured_yuv_frames(0, 12, 192, 256)
    _, _, d = jax_step.run_offline(yuv, CFG, dict(PARAMS), debug=True)
    hues = np.asarray(d["hues"]).astype(np.int64)
    args = np.stack([np.asarray(jf.hist_max_and_arg(jf.frame_stats(
        {k: v[i] for k, v in yuv.items()}, CFG)[0])[1]).astype(np.int64)
        for i in range(12)])
    prev = np.vstack([np.zeros((1, 16), np.int64), hues[:-1]])
    assert np.all((9 * prev + args) % 10 != 0)
    assert len(np.unique(hues)) > 40


@pytest.mark.parametrize("channels", [1, 2])
def test_chunked_yuv_matches_jax(channels):
    """run_offline_batched on a YUV dict, T=12 in chunks of 8 (one ragged
    chunk of 4): hues equal, PCM within 2e-5, phases bit for bit."""
    cfg = AuralizerConfig(channels=channels)
    yuv = structured_yuv_frames(1, 12, 192, 256)
    assert_runs_agree(
        jax_chunked.run_offline_batched(yuv, cfg, dict(PARAMS), chunk=8,
                                        debug=True),
        chunked.run_offline_batched(yuv, cfg, dict(PARAMS), chunk=8,
                                    debug=True, device="cpu"))


def test_per_frame_yuv_matches_jax():
    yuv = structured_yuv_frames(2, 4, 192, 256)
    cfg = AuralizerConfig(channels=2)
    assert_runs_agree(
        jax_step.run_offline(yuv, cfg, dict(PARAMS), debug=True),
        step.run_offline(yuv, cfg, dict(PARAMS), debug=True, device="cpu"))


def test_blocked_yuv_matches_jax():
    """run_offline(block=4) over 10 frames: two blocks and a remainder."""
    yuv = structured_yuv_frames(3, 10, 192, 256)
    assert_runs_agree(
        jax_step.run_offline(yuv, CFG, dict(PARAMS), debug=True, block=4),
        step.run_offline(yuv, CFG, dict(PARAMS), debug=True, block=4,
                         device="cpu"))


def test_yuv_with_the_vision_kernel_path_matches_jax(monkeypatch):
    """use_pallas_vision on YUV mips (K3's plain version here; the JAX
    package's kernel in interpret mode): hues equal, PCM within 2e-5."""
    monkeypatch.setattr(jf, "_PALLAS_POOL_ON_CPU", True)
    cfg = AuralizerConfig(use_pallas_vision=True, use_pallas_pool=False)
    yuv = structured_yuv_frames(4, 8, 192, 256)
    assert_runs_agree(
        jax_chunked.run_offline_batched(yuv, cfg, dict(PARAMS), chunk=8,
                                        debug=True),
        chunked.run_offline_batched(yuv, cfg, dict(PARAMS), chunk=8,
                                    debug=True, device="cpu"))


def yuv_frames_list(yuv):
    return [{k: v[i] for k, v in yuv.items()} for i in range(len(yuv["y"]))]


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_the_stream_takes_yuv_dicts(chunk_frames):
    """YUV dict frames per frame and in chunks (stacked per plane): the
    stream's PCM equals the port's offline runs bit for bit, and the JAX
    stream's within 2e-5."""
    cfg = AuralizerConfig(channels=2, use_pallas=True, use_pallas_vision=True,
                          ring_buffer_frames=64)
    yuv = structured_yuv_frames(5, 10, 64, 128)
    frames = yuv_frames_list(yuv)
    aur = Auralizer(source=frames, config=cfg, device="cpu",
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=60)
    got = aur.pull(10 * 2048 * 2)
    assert aur.metrics["dispatches"] == (10 if chunk_frames == 1 else 4)
    if chunk_frames == 1:
        ref, _, _ = step.run_offline(yuv, cfg, device="cpu")
    else:
        head, carry, _ = chunked.run_offline_batched(
            {k: v[:8] for k, v in yuv.items()}, cfg, chunk=4, device="cpu")
        tail, _, _ = step.run_offline({k: v[8:] for k, v in yuv.items()},
                                      cfg, carry=carry, device="cpu")
        ref = torch.cat([head, tail])
    np.testing.assert_array_equal(got, ref.numpy().reshape(-1))
    jax_stream = JaxStream(cfg, prefer_native=False,
                           chunk_frames=chunk_frames)
    jax_stream.run_until_exhausted(frames, timeout=120)
    np.testing.assert_allclose(got, jax_stream.pull(10 * 2048 * 2),
                               atol=PCM_ATOL)


def test_the_stream_counts_a_yuv_resolution_change():
    """The resolution check reads the shape of y."""
    small = yuv_frames_list(structured_yuv_frames(6, 3, 64, 64))
    large = yuv_frames_list(structured_yuv_frames(7, 3, 64, 128))
    aur = Auralizer(source=small + large,
                    config=AuralizerConfig(ring_buffer_frames=16),
                    device="cpu", chunk_frames=2)
    aur.run_until_exhausted(timeout=60)
    m = aur.metrics
    assert m["resolution_changes"] == 1 and m["frames_processed"] == 6


def test_a_yuv_file_streams_through_the_front_door(tmp_path):
    """Yuv420FileSource(raw=True) as the source of a live Auralizer."""
    yuv = structured_yuv_frames(8, 4, 64, 64)
    path = tmp_path / "c.yuv"
    path.write_bytes(b"".join(yuv420_bytes(yuv, k, "nv12") for k in range(4)))
    src = tio.Yuv420FileSource(str(path), width=64, height=64, raw=True,
                               fmt="nv12")
    aur = Auralizer(source=src, config=CFG, device="cpu")
    aur.run_until_exhausted(timeout=60)
    ref, _, _ = step.run_offline(yuv, CFG, device="cpu")
    np.testing.assert_array_equal(aur.pull(4 * 2048), ref.numpy())


def test_sonify_takes_a_yuv_dict_and_picks_its_mode_by_frames():
    """sonify on a 12-frame dict runs chunked (three planes must not read
    as three frames), a 4-frame dict frame by frame; both against the JAX
    package's sonify: PCM within 2e-5."""
    from vaudio.api import Auralizer as JaxAuralizer
    cfg = AuralizerConfig(channels=2)
    for T, run in ((12, chunked.run_offline_batched), (4, step.run_offline)):
        yuv = structured_yuv_frames(9 + T, T, 192, 256)
        got = Auralizer(config=cfg, device="cpu").sonify(yuv)
        mode_ref, _, _ = run(yuv, cfg, dict(PARAMS), device="cpu")
        np.testing.assert_array_equal(got, mode_ref.numpy())
        ref = JaxAuralizer(config=cfg).sonify(yuv)
        np.testing.assert_allclose(got, ref, atol=PCM_ATOL)
    rgb = structured_frames(9, 12, 64, 64)
    np.testing.assert_array_equal(
        Auralizer(config=cfg, device="cpu").sonify(list(rgb)),
        Auralizer(config=cfg, device="cpu").sonify(rgb))
