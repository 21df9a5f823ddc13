"""The port's debug-surface renderers (vaudio_torch.utils.render and
.display) against the JAX package's on the same numpy inputs: PNG bytes
equal for every view, the debug surface's files equal byte for byte."""

import numpy as np
import pytest

import vaudio.utils.display as jax_display
import vaudio.utils.render as jax_render
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.utils import display, render

CFG, JCFG = AuralizerConfig(), JaxConfig()


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def hues(rng):
    h = rng.integers(0, 360, 16).astype(np.int32)
    h[[3, 9]] = (361, -1)                   # invalid bins draw gray
    return h


def test_png_writer_equals_jax(rng, tmp_path):
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    assert render.png_bytes(img) == jax_render.png_bytes(img)
    render.write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == jax_render.png_bytes(img)
    with pytest.raises(ValueError):
        render.png_bytes(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("view", [
    "signed_heatmap", "hue_matrix", "spectrum_mono", "spectrum_stereo",
    "waveform_mono", "waveform_stereo", "curve", "hsb"])
def test_view_png_equals_jax(rng, view):
    spec = rng.normal(size=(2, CFG.num_bins, 2)).astype(np.float32)
    pcm = rng.normal(size=(2048, 2)).astype(np.float32)
    x = np.sort(rng.uniform(0, 1, 40)).astype(np.float32)
    y = rng.uniform(-0.2, 1.2, 40).astype(np.float32)
    calls = {
        "signed_heatmap": lambda m, c: m.signed_heatmap(
            np.linspace(-1.5, 1.5, 60, dtype=np.float32).reshape(6, 10),
            upscale=3),
        "hue_matrix": lambda m, c: m.hue_matrix_image(hues(rng), c),
        "spectrum_mono": lambda m, c: m.spectrum_image(spec[0], c),
        "spectrum_stereo": lambda m, c: m.spectrum_image(spec, c),
        "waveform_mono": lambda m, c: m.waveform_image(pcm[:, 1]),
        "waveform_stereo": lambda m, c: m.waveform_image(pcm),
        "curve": lambda m, c: m.curve_image(x, y, 120, 50),
        "hsb": lambda m, c: (m.hsb_to_rgb_array(
            np.linspace(-0.3, 1.7, 30, dtype=np.float32)) * 255 + 0.5
        ).astype(np.uint8).reshape(5, 6, 3),
    }
    state = rng.bit_generator.state
    got = calls[view](render, CFG)
    rng.bit_generator.state = state
    ref = calls[view](jax_render, JCFG)
    assert got.dtype == np.uint8
    assert render.png_bytes(got) == jax_render.png_bytes(ref)


@pytest.mark.parametrize("kind", ["rgb_u8", "rgb_f32", "yuv", "yuv_odd",
                                  "small"])
def test_input_preview_equals_jax(rng, kind):
    """The input preview: RGB u8 and f32 subsampled to 256 on the long
    edge, planar YUV dicts (an odd-sized luma too), a small frame as is."""
    frame = {
        "rgb_u8": lambda: rng.integers(0, 256, (300, 520, 3),
                                       dtype=np.uint8),
        "rgb_f32": lambda: rng.uniform(-0.1, 1.1, (270, 300, 3)).astype(
            np.float32),
        "yuv": lambda: {"y": rng.integers(0, 256, (540, 960), np.uint8),
                        "u": rng.integers(0, 256, (270, 480), np.uint8),
                        "v": rng.integers(0, 256, (270, 480), np.uint8)},
        "yuv_odd": lambda: {"y": rng.integers(0, 256, (301, 515), np.uint8),
                            "u": rng.integers(0, 256, (151, 258), np.uint8),
                            "v": rng.integers(0, 256, (151, 258), np.uint8)},
        "small": lambda: rng.integers(0, 256, (12, 20, 3), dtype=np.uint8),
    }[kind]()
    got = render.input_preview_image(frame)
    ref = jax_render.input_preview_image(frame)
    assert max(got.shape[:2]) <= 256
    assert render.png_bytes(got) == jax_render.png_bytes(ref)
    with pytest.raises(ValueError, match="RGB or a YUV dict"):
        render.input_preview_image(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("refresh,with_maps", [(None, True), (1.0, False)])
def test_render_debug_surface_writes_the_jax_files(rng, tmp_path, refresh,
                                                   with_maps):
    """render_debug_surface writes the JAX package's files byte for byte:
    the heatmaps, hue matrix, input preview, spectrum, waveform, the grid
    overlay JSON and index.html (with or without the refresh tag)."""
    info = {"hues": hues(rng),
            "grads": rng.normal(size=(16, 4)).astype(np.float32)}
    if with_maps:
        for ch in ("hue", "saturation", "intensity"):
            info[f"{ch}_map"] = rng.normal(size=(24, 16, 4)).astype(
                np.float32)
    spec = rng.normal(size=(CFG.num_bins, 2)).astype(np.float32)
    pcm = rng.normal(size=2048).astype(np.float32)
    frame = {"y": rng.integers(0, 256, (64, 96), np.uint8),
             "u": rng.integers(0, 256, (32, 48), np.uint8),
             "v": rng.integers(0, 256, (32, 48), np.uint8)}
    outs = []
    for mod, cfg, sub in ((render, CFG, "port"), (jax_render, JCFG, "jax")):
        written = mod.render_debug_surface(
            info, cfg, str(tmp_path / sub), spectrum=spec, pcm=pcm,
            refresh_seconds=refresh, input_frame=frame)
        outs.append({k: open(v, "rb").read() for k, v in written.items()})
    assert outs[0] == outs[1]
    assert len(outs[0]) == (12 if with_maps else 0) + 6
    assert (b"http-equiv" in outs[0]["index"]) == (refresh is not None)


def test_display_curves_equal_jax(rng):
    """spectrum_display (numpy) equal to the JAX package's; the peak-shape
    curve (the port's hann_sinc_peak on a CPU tensor) within 1e-6."""
    spec = rng.normal(size=(CFG.num_bins, 2)).astype(np.float32)
    got = display.spectrum_display(spec, CFG)
    ref = jax_display.spectrum_display(spec, JCFG)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    for kwargs in (dict(), dict(bandwidth=2.5, q=3.0, n=101)):
        d, w = display.peak_shape_curve(**kwargs)
        d_ref, w_ref = jax_display.peak_shape_curve(**kwargs)
        np.testing.assert_array_equal(d, d_ref)
        assert w.dtype == np.asarray(w_ref).dtype
        np.testing.assert_allclose(w, np.asarray(w_ref), atol=1e-6)
