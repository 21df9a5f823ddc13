"""Render the observability data feeds to PNG images — the PyTorch port's
copy of :mod:`vaudio.utils.render`, the framework's equivalent of the
reference's debug/visualization screens.

The reference draws these live in SwiftUI:

* per-pixel signed heatmaps of the mode maps, green for positive and red
  for negative with |value| as opacity over black
  (Views/DebuggingView.swift:96-135, ``HeatmapView``);
* the 4x4 dominant-hue swatch matrix, full-saturation HSB color per cell,
  gray for invalid bins (Views/DebuggingView.swift:174-218, ``DebugMatrix``
  / ``CellView``);
* the log-frequency dB spectrum polyline (Views/SpectrumView.swift:15-77);
* the time-domain waveform polyline (Views/TimeDomainFrameView.swift:15-51).

Here each becomes a pure-numpy image builder plus a tiny stdlib PNG writer
(zlib + struct — no image library dependencies), consumed by the live
server's debug views and the live debug surface, and usable from
notebooks.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from vaudio_torch.config import AuralizerConfig

MODE_NAMES = ("breathing", "vtilt", "htilt", "saddle")
CHANNEL_NAMES = ("hue", "saturation", "intensity")


# ---------------------------------------------------------------------------
# PNG writer (stdlib only)
# ---------------------------------------------------------------------------

def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode u8[H, W, 3] RGB as an 8-bit truecolor PNG byte string."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected u8[H,W,3], got {rgb.dtype}{rgb.shape}")
    h, w = rgb.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write u8[H, W, 3] RGB to ``path`` as an 8-bit truecolor PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


# ---------------------------------------------------------------------------
# Image builders
# ---------------------------------------------------------------------------

def signed_heatmap(values: np.ndarray, upscale: int = 1) -> np.ndarray:
    """f32[H, W] signed map -> u8[H, W, 3]: the reference's green/red
    heatmap (DebuggingView.swift:125-128: positive green, negative red,
    opacity min(|v|, 1) composited over black)."""
    v = np.asarray(values, np.float32)
    a = np.minimum(np.abs(v), 1.0)
    img = np.zeros(v.shape + (3,), np.float32)
    img[..., 1] = np.where(v >= 0, a, 0.0)   # green
    img[..., 0] = np.where(v < 0, a, 0.0)    # red
    out = (img * 255.0 + 0.5).astype(np.uint8)
    if upscale > 1:
        out = np.repeat(np.repeat(out, upscale, axis=0), upscale, axis=1)
    return out


def hsb_to_rgb_array(h: np.ndarray, s: float = 1.0, b: float = 1.0
                     ) -> np.ndarray:
    """Vectorized HSB->RGB (the SwiftUI Color(hue:saturation:brightness:)
    model used for the hue swatches)."""
    h6 = (np.asarray(h, np.float32) % 1.0) * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = np.full_like(f, b * (1.0 - s))
    q = b * (1.0 - s * f)
    t = b * (1.0 - s * (1.0 - f))
    bb = np.full_like(f, b)
    lut = np.stack([
        np.stack([bb, t, p], -1), np.stack([q, bb, p], -1),
        np.stack([p, bb, t], -1), np.stack([p, q, bb], -1),
        np.stack([t, p, bb], -1), np.stack([bb, p, q], -1)], 0)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]


def input_preview_image(frame, max_dim: int = 256) -> np.ndarray:
    """Ingested frame -> u8[h, w, 3] RGB preview, strided-subsampled to
    at most ``max_dim`` on the long edge — the live camera-preview
    surface (Views/CameraPreview.swift:11-51 wraps the capture feed in
    ``AVCaptureVideoPreviewLayer``; here the last ingested frame is the
    feed).

    Accepts what the streaming pipeline ingests: ``[H, W, 3]`` RGB
    (uint8, or float in [0, 1]) or a planar-YUV dict ``{'y','u','v'}``
    (converted BT.601 studio-swing, matching the device ingest path
    :func:`vaudio_torch.vision.features.yuv420_mip_to_rgb_planes`).
    Subsampling happens BEFORE any dtype/color conversion so a 1080p
    preview costs ~0.2 MB of host work, not a full-frame pass.
    """
    if isinstance(frame, dict):
        plane = np.asarray(frame["y"])
    else:
        plane = rgb = np.asarray(frame)
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] RGB or a YUV dict, got "
                             f"shape {rgb.shape}")
    step = max(1, (max(plane.shape[:2]) + max_dim - 1) // max_dim)
    if isinstance(frame, dict):
        # Chroma is sampled at the SAME spatial sites as the luma
        # (4:2:0 puts luma row r's chroma at plane row r//2), so the
        # preview stays color-aligned for odd steps too; the chroma
        # then already matches the subsampled luma's shape and
        # yuv420_to_rgb skips its 2x upsample.
        yi = np.arange(0, plane.shape[0], step)
        xi = np.arange(0, plane.shape[1], step)
        u, v = np.asarray(frame["u"]), np.asarray(frame["v"])
        ci = np.minimum(yi // 2, u.shape[0] - 1)   # clamp: odd-height
        cj = np.minimum(xi // 2, u.shape[1] - 1)   # luma, floored chroma
        from vaudio_torch.io.sources import yuv420_to_rgb
        return yuv420_to_rgb(plane[np.ix_(yi, xi)],
                             u[np.ix_(ci, cj)], v[np.ix_(ci, cj)])
    rgb = rgb[::step, ::step]
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb.astype(np.float32), 0.0, 1.0)
               * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def hue_matrix_image(hues: np.ndarray, cfg: AuralizerConfig,
                     cell_px: int = 45, gap: int = 2) -> np.ndarray:
    """i32[16] hue bins -> the 4x4 dominant-hue swatch matrix
    (DebuggingView.swift:174-218): Color(hue: bin/360, s:1, b:1) per cell,
    gray for bins > 360, black gaps."""
    g = cfg.grid_size
    hues = np.asarray(hues).reshape(g, g)
    side = g * cell_px + (g + 1) * gap
    img = np.zeros((side, side, 3), np.uint8)
    for r in range(g):
        for c in range(g):
            bin_ = int(hues[r, c])
            if bin_ > 360 or bin_ < 0:
                color = np.array([77, 77, 77], np.uint8)  # gray .3
            else:
                rgb = hsb_to_rgb_array(np.float32(bin_) / 360.0)
                color = (rgb * 255.0 + 0.5).astype(np.uint8)
            y0 = gap + r * (cell_px + gap)
            x0 = gap + c * (cell_px + gap)
            img[y0:y0 + cell_px, x0:x0 + cell_px] = color
    return img


def curve_image(x01: np.ndarray, y01: np.ndarray, width: int = 640,
                height: int = 240, color=(64, 224, 128),
                background=(8, 8, 12)) -> np.ndarray:
    """Rasterize a polyline of normalized (x, y) in [0,1] (y up) to
    u8[height, width, 3] — the Canvas-polyline equivalent."""
    img = np.empty((height, width, 3), np.uint8)
    img[...] = np.asarray(background, np.uint8)
    x = np.clip(np.asarray(x01, np.float32), 0, 1) * (width - 1)
    y = (1.0 - np.clip(np.asarray(y01, np.float32), 0, 1)) * (height - 1)
    if x.size == 0:
        return img
    # Dense-sample each segment so diagonal lines have no gaps.
    seg = np.maximum(np.abs(np.diff(x)), np.abs(np.diff(y)))
    col = np.asarray(color, np.uint8)
    for i in range(x.size - 1):
        n = int(seg[i]) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        xi = (x[i] + t * (x[i + 1] - x[i]) + 0.5).astype(np.int32)
        yi = (y[i] + t * (y[i + 1] - y[i]) + 0.5).astype(np.int32)
        img[yi, xi] = col
    return img


def spectrum_image(spectrum: np.ndarray, cfg: AuralizerConfig,
                   width: int = 640, height: int = 240) -> np.ndarray:
    """f32[F, 2] complex half-spectrum -> the SpectrumView log-f dB curve
    (Views/SpectrumView.swift:15-77) as an image."""
    from vaudio_torch.utils.display import spectrum_display
    spectrum = np.asarray(spectrum)
    if spectrum.ndim == 3:            # stereo: draw the left channel
        spectrum = spectrum[0]
    d = spectrum_display(spectrum, cfg)
    return curve_image(d["log_x"], d["norm_y"], width, height)


def waveform_image(pcm: np.ndarray, width: int = 640, height: int = 160
                   ) -> np.ndarray:
    """f32[N] (or interleaved f32[N, ch] — channel 0) PCM -> the
    TimeDomainFrameView polyline (Views/TimeDomainFrameView.swift:15-51)."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 2:
        pcm = pcm[:, 0]
    n = pcm.size
    x = np.arange(n, dtype=np.float32) / max(n - 1, 1)
    peak = float(np.abs(pcm).max()) or 1.0
    y = 0.5 + 0.5 * (pcm / peak)
    return curve_image(x, y, width, height, color=(240, 200, 80))


# ---------------------------------------------------------------------------
# High-level: render a frame's full debug surface
# ---------------------------------------------------------------------------

def render_debug_surface(inspect_out: Dict[str, np.ndarray],
                         cfg: AuralizerConfig, out_dir: str,
                         spectrum: Optional[np.ndarray] = None,
                         pcm: Optional[np.ndarray] = None,
                         heatmap_upscale: int = 4,
                         refresh_seconds: Optional[float] = None,
                         input_frame=None) -> Dict[str, str]:
    """Write the ConvolutionDebugView + SpectrumView + TimeDomainFrameView
    surfaces for one analyzed frame as PNGs (+ a JSON with the numeric
    4x4 grid-overlay values).

    Args:
      inspect_out: the dict returned by :meth:`Auralizer.inspect_frame`
        (hues, grads, histogram, {hue,saturation,intensity}_map).
      spectrum / pcm: optional synthesis state to also render the
        spectrum and waveform views.
      refresh_seconds: emit a ``<meta http-equiv=refresh>`` tag in
        index.html so a browser pointed at a live-updating directory
        re-reads it — the TimelineView(.animation) equivalent
        (Views/SpectrumView.swift:18).  None = static page.
      input_frame: optional ingested frame (RGB array or YUV dict) to
        render as a downsampled ``input.png`` preview — the
        CameraPreview surface (Views/CameraPreview.swift:11-51).
    Returns: {name: written path}.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}

    def put(name: str, img: np.ndarray) -> None:
        path = os.path.join(out_dir, name + ".png")
        write_png(path, img)
        written[name] = path

    # Per-pixel mode heatmaps, one per (channel, mode) — the reference's
    # channel picker x mode picker (DebuggingView.swift:18-34).
    for ch in CHANNEL_NAMES:
        maps = inspect_out.get(f"{ch}_map")
        if maps is None:
            continue
        maps = np.asarray(maps)
        for m, mode in enumerate(MODE_NAMES):
            put(f"heatmap_{ch}_{mode}",
                signed_heatmap(maps[..., m], upscale=heatmap_upscale))

    put("hue_matrix", hue_matrix_image(inspect_out["hues"], cfg))

    if input_frame is not None:
        put("input", input_preview_image(input_frame))

    if spectrum is not None:
        put("spectrum", spectrum_image(spectrum, cfg))
    if pcm is not None:
        put("waveform", waveform_image(pcm))

    # The numeric grid overlay (DebuggingView.swift:138-171) as data.
    grid = {
        "hues": np.asarray(inspect_out["hues"]).tolist(),
        "grads": {mode: np.asarray(inspect_out["grads"])[:, m].tolist()
                  for m, mode in enumerate(MODE_NAMES)},
    }
    grid_path = os.path.join(out_dir, "grid_overlay.json")
    with open(grid_path, "w") as f:
        json.dump(grid, f, indent=2)
    written["grid_overlay"] = grid_path

    written["index"] = write_debug_html(out_dir, written, grid,
                                        refresh_seconds=refresh_seconds)
    return written


def write_debug_html(out_dir: str, written: Dict[str, str],
                     grid: Dict,
                     refresh_seconds: Optional[float] = None) -> str:
    """Assemble the rendered artifacts into one ``index.html`` — the
    single-page equivalent of the reference's debug screen (heatmap +
    pickers + grid overlay + hue matrix + spectrum + waveform on one
    SwiftUI view, Views/DebuggingView.swift:37-93).  Pure stdlib; images
    referenced by relative path."""
    def img(name, width=None):
        if name not in written:
            return ""
        w = f' width="{width}"' if width else ""
        return (f'<figure><img src="{os.path.basename(written[name])}"'
                f'{w}><figcaption>{name}</figcaption></figure>')

    heat_rows = []
    for ch in CHANNEL_NAMES:
        cells = "".join(img(f"heatmap_{ch}_{m}", 220) for m in MODE_NAMES)
        if cells:
            heat_rows.append(f"<h3>{ch}</h3><div class='row'>{cells}</div>")

    g = int(np.sqrt(len(grid["hues"]))) or 4
    def table(vals, fmt):
        rows = []
        for r in range(g):
            tds = "".join(f"<td>{fmt(v)}</td>"
                          for v in vals[r * g:(r + 1) * g])
            rows.append(f"<tr>{tds}</tr>")
        return "<table>" + "".join(rows) + "</table>"

    grad_tables = "".join(
        f"<h4>{mode}</h4>" + table(grid["grads"][mode],
                                   lambda v: f"{v:.3f}")
        for mode in MODE_NAMES if mode in grid["grads"])

    refresh = (f'<meta http-equiv="refresh" '
               f'content="{refresh_seconds:g}">'
               if refresh_seconds else "")
    html = f"""<!doctype html><meta charset="utf-8">{refresh}
<title>vaudio debug surface</title>
<style>
 body {{ background:#111; color:#ddd; font:14px system-ui; margin:2em; }}
 .row {{ display:flex; gap:12px; flex-wrap:wrap; }}
 figure {{ margin:0; }} figcaption {{ color:#888; font-size:11px; }}
 img {{ image-rendering:pixelated; border:1px solid #333; }}
 table {{ border-collapse:collapse; margin:4px 0; }}
 td {{ border:1px solid #333; padding:3px 8px; font-family:monospace; }}
</style>
<h1>vaudio debug surface</h1>
{('<h2>Input</h2><div class="row">' + img('input', 240) + '</div>')
 if 'input' in written else ''}
<h2>Dominant hues (4x4)</h2>
<div class="row">{img('hue_matrix')}
<div>{table(grid['hues'], lambda v: int(v))}</div></div>
<h2>Spectrum / waveform</h2>
<div class="row">{img('spectrum')}{img('waveform')}</div>
<h2>Per-pixel mode heatmaps (green +, red -)</h2>
{''.join(heat_rows)}
<h2>Grid overlay (per-cell gradient stats)</h2>
{grad_tables}
"""
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(html)
    return path
