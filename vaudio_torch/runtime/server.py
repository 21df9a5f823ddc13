"""Live HTTP control panel + observability server for a running stream —
the PyTorch port's copy of :mod:`vaudio.runtime.server`.

The reference's interaction model is a SwiftUI surface: sliders mutating
``@Published`` synthesis parameters while processing runs
(Views/ControlPanelView.swift:11-43, Views/ExtraControlView.swift:10-52,
SoundEngine.swift:66-75), views that redraw continuously from the live
engine state (Views/SpectrumView.swift:18 ``TimelineView(.animation)``,
Views/TimeDomainFrameView.swift:15, Views/DebuggingView.swift:37-93), and
a speaker fed by a pull-model source node (SoundEngine.swift:156-228).

:class:`LiveServer` is the framework's browser equivalent, built on the
stdlib only (``http.server``): one ephemeral HTTP endpoint exposing

* ``GET /``            — the control panel: sliders for every
  :class:`~vaudio_torch.config.LiveParams` field, live-refreshing hue-matrix /
  spectrum / waveform views, and a metrics readout;
* ``GET /params``      — current live parameters as JSON;
* ``POST /params``     — a JSON object of parameter updates, applied via
  :func:`~vaudio_torch.runtime.control.apply_control_message` (same
  validation as the control channel; the step copies the params to the
  device at every dispatch, so an update applies on the next frame);
* ``GET /metrics``     — :attr:`Auralizer.metrics` as JSON;
* ``GET /metrics.prom`` — the same numbers in Prometheus text
  exposition format (a scrape target for production monitoring);
* ``GET /state.npz`` / ``POST /state.npz`` — checkpoint download /
  restore of the live DSP carry over HTTP (``save_state`` /
  ``load_state`` for ops: snapshot or migrate a running stream without
  touching its filesystem; the JAX package's ``.npz`` format);
* ``GET /debug/hue_matrix.png`` / ``spectrum.png`` / ``waveform.png`` —
  the latest published debug state rendered on demand (in-memory PNG;
  the stream must run with ``debug=True``);
* ``GET /debug/input.png`` — a downsampled preview of the last ingested
  frame (the CameraPreview surface, Views/CameraPreview.swift:11-51;
  also needs ``debug=True``, which makes the stream keep the frame);
* ``POST /frames``     — network frame ingest when the stream's source
  is a :class:`vaudio_torch.io.PushSource`:
  one frame per request as a self-describing ``.npy`` body, a
  planar-YUV ``.npz``, or raw ``rgb24``/``i420``/``nv12`` bytes with
  ``?w=&h=&fmt=`` (:func:`decode_frame_body`) — the capture delegate's
  push contract over HTTP (VisionEngine.swift:77-101).  A full queue
  drops its oldest frame (newest wins, CameraModel.swift:24);
* ``GET /push`` / ``POST /push`` — inbound push-queue state / close
  (``{"close": true}`` ends the stream once the queue drains);
* ``GET /audio.wav``   — a live 16-bit WAV stream pulled from the audio
  ring at the hardware cadence (the AVAudioSourceNode equivalent, so a
  browser ``<audio>`` element IS the speaker).  One listener at a time;
  note any other ring consumer (``Auralizer.pull``) splits samples with
  it.

Usage::

    aur = Auralizer(source=PushSource(when_empty="block"), config=cfg)
    server = aur.serve(port=8000)      # -> LiveServer, non-blocking
    aur.start()
    push_frames(server.url, None, frames)
    ...
    server.stop()
    aur.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vaudio_torch.runtime.control import (CONTROLLABLE,
                                          apply_control_message)

#: Slider ranges for the control panel (min, max, step) — spans matching
#: the reference's slider surfaces (ControlPanelView.swift:24,31 cutoff
#: ranges; ExtraControlView.swift:21-28 attack/release/mixing).
_SLIDERS = (
    ("attack", 0.01, 5.0, 0.01),
    ("release", 0.01, 5.0, 0.01),
    ("spectrum_mixing", 0.0, 0.999, 0.001),
    ("hp_cutoff", 20.0, 2000.0, 1.0),
    ("lp_cutoff", 1000.0, 22050.0, 10.0),
    ("hp_order", 0.0, 8.0, 0.125),
    ("lp_order", 0.0, 8.0, 0.125),
    ("stereo_width", 0.0, 2.0, 0.01),
)

_PAGE = """<!doctype html><meta charset="utf-8">
<title>vaudio live</title>
<style>
 body {{ font: 14px system-ui, sans-serif; background: #101014;
        color: #d8d8e0; margin: 1.5em; }}
 h1 {{ font-size: 1.2em; }} h2 {{ font-size: 1em; color: #9ab; }}
 .row {{ display: flex; gap: 2em; flex-wrap: wrap; }}
 .panel {{ background: #17171d; border-radius: 8px; padding: 1em; }}
 label {{ display: grid; grid-template-columns: 10em 14em 4.5em;
          align-items: center; gap: .6em; margin: .35em 0; }}
 output {{ font-variant-numeric: tabular-nums; color: #8fd; }}
 img {{ image-rendering: pixelated; border-radius: 4px; display: block;
        margin-top: .5em; }}
 pre {{ color: #9a9; }}
</style>
<h1>vaudio — live stream control</h1>
<div class="row">
 <div class="panel"><h2>parameters</h2><div id="sliders"></div>
  <h2>audio</h2><audio controls preload="none" src="/audio.wav{qs}"></audio>
 </div>
 <div class="panel"><h2>input</h2><img id="input" width="240">
  <h2>dominant hues</h2><img id="hue_matrix" width="190"></div>
 <div class="panel"><h2>spectrum</h2><img id="spectrum">
  <h2>waveform</h2><img id="waveform"></div>
 <div class="panel"><h2>metrics</h2><pre id="metrics">...</pre></div>
</div>
<script>
const SLIDERS = {sliders};
const box = document.getElementById("sliders");
let current = {{}};
fetch("/params{qs}").then(r => r.json()).then(p => {{
  current = p;
  for (const [name, lo, hi, step] of SLIDERS) {{
    const l = document.createElement("label");
    l.innerHTML = `<span>${{name}}</span>` +
      `<input type=range min=${{lo}} max=${{hi}} step=${{step}} ` +
      `value="${{p[name]}}" id="in_${{name}}">` +
      `<output id="out_${{name}}">${{Number(p[name]).toFixed(3)}}</output>`;
    box.appendChild(l);
    const inp = l.querySelector("input"), out = l.querySelector("output");
    inp.oninput = () => {{
      out.textContent = Number(inp.value).toFixed(3);
      fetch("/params{qs}", {{method: "POST",
        body: JSON.stringify({{[name]: Number(inp.value)}})}});
    }};
  }}
}});
function tick() {{
  const t = Date.now();
  for (const id of ["input", "hue_matrix", "spectrum", "waveform"])
    document.getElementById(id).src = `/debug/${{id}}.png?t=${{t}}{qs_amp}`;
  fetch("/metrics{qs}").then(r => r.json()).then(m => {{
    document.getElementById("metrics").textContent =
      JSON.stringify(m, null, 1);
  }});
}}
tick(); setInterval(tick, {refresh_ms});
</script>
"""


def check_auth(handler, token: Optional[str]) -> bool:
    """Bearer-token gate for a panel request (both panels share it).

    With ``token=None`` (the default) every request passes — the
    panels bind 127.0.0.1 unless told otherwise.  With a token set,
    EVERY endpoint (including the page itself) requires it, via
    ``Authorization: Bearer <token>`` or a ``?token=`` query parameter
    (the browser panel's ``<img>``/``<audio>`` URLs cannot carry
    headers; the page embeds the token it was fetched with).
    Constant-time compare; failures answer 401 JSON and return False
    (the caller returns immediately)."""
    if token is None:
        return True
    import hmac
    from urllib.parse import parse_qs, urlsplit
    auth = handler.headers.get("Authorization", "")
    got = auth[len("Bearer "):] if auth.startswith("Bearer ") else None
    if got is None:
        q = parse_qs(urlsplit(handler.path).query)
        got = (q.get("token") or [None])[0]
    # Compare as bytes: str compare_digest raises TypeError on any
    # non-ASCII input, and a remote request must never be able to
    # raise out of the auth gate (it would reset the connection and
    # traceback to the serving process stderr instead of answering 401).
    if got is not None and hmac.compare_digest(got.encode(),
                                               token.encode()):
        return True
    handler._json({"error": "unauthorized: pass 'Authorization: "
                   "Bearer <token>' or '?token='"}, 401)
    return False


def prometheus_text(metrics: dict, prefix: str = "vaudio") -> str:
    """Flatten a metrics dict to Prometheus text exposition format
    (text/plain; version=0.0.4) for scraping: numeric/boolean scalars
    become gauges; a ``"slots"`` list of per-slot dicts becomes labeled
    series (``vaudio_slot_buffer_fill{slot="0"} 3``); everything else is
    skipped."""
    lines = []

    def emit(name: str, value, labels: str = ""):
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        metric = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
        if not any(line.startswith(f"# TYPE {metric} ")
                   for line in lines):
            lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{labels} {value}")

    for key, value in metrics.items():
        if key == "slots" and isinstance(value, list) and value:
            # Metric-major: all samples of one metric must form a single
            # group (Prometheus text exposition format requirement) —
            # slot-major emission would interleave them.
            # Union of keys across slots: per-slot-only metrics (e.g. a
            # push-armed slot's queue gauges) must emit even when slot 0
            # lacks them.
            keys = dict.fromkeys(k for slot in value for k in slot)
            for k in keys:
                for i, slot in enumerate(value):
                    emit(f"slot_{k}", slot.get(k),
                         labels=f'{{slot="{i}"}}')
        else:
            emit(key, value)
    return "\n".join(lines) + "\n"


#: Upper bound on a pushed-frame HTTP body (a float32 4K RGB frame is
#: ~95 MB; anything past this is a client bug, not a frame).
MAX_FRAME_BODY = 256 * 1024 * 1024


def decode_frame_body(body: bytes, query: dict):
    """Decode one pushed video frame from an HTTP request body (the
    network-ingest counterpart of the capture delegate's CVPixelBuffer,
    VisionEngine.swift:77-101).  Accepted encodings:

    * a ``.npy`` array (self-describing shape/dtype — the preferred
      form; ``numpy.save`` to a socket on the client side);
    * a ``.npz`` with planar-YUV members ``y``/``u``/``v`` for the
      device-side 4:2:0 path;
    * raw bytes with ``?w=&h=`` query params and optional
      ``fmt=rgb24|i420|nv12`` (default rgb24) — the ffmpeg-pipe-friendly
      form.

    Raises ``ValueError`` on anything else."""
    import io as _io
    if len(body) > MAX_FRAME_BODY:
        raise ValueError(f"frame body {len(body)} bytes exceeds the "
                         f"{MAX_FRAME_BODY}-byte limit")
    if body[:6] == b"\x93NUMPY":
        try:
            return np.load(_io.BytesIO(body), allow_pickle=False)
        except Exception as e:    # truncated/corrupt .npy: EOFError etc.
            raise ValueError(f"undecodable .npy body: {e}") from None
    if body[:4] == b"PK\x03\x04":          # .npz is a zip archive
        try:
            z = np.load(_io.BytesIO(body), allow_pickle=False)
            return {k: z[k] for k in z.files}
        except Exception as e:    # zipfile.BadZipFile on truncation etc.
            raise ValueError(f"undecodable .npz body: {e}") from None
    w, h = query.get("w"), query.get("h")
    if not (w and h):
        raise ValueError("raw frame bytes need ?w=&h= query params "
                         "(or send a self-describing .npy body)")
    w, h = int(w), int(h)
    fmt = query.get("fmt", "rgb24")
    if fmt == "rgb24":
        expect = h * w * 3
        if len(body) != expect:
            raise ValueError(f"rgb24 {w}x{h} needs {expect} bytes, "
                             f"got {len(body)}")
        return np.frombuffer(body, np.uint8).reshape(h, w, 3)
    if fmt in ("i420", "nv12"):
        expect = h * w * 3 // 2
        if len(body) != expect:
            raise ValueError(f"{fmt} {w}x{h} needs {expect} bytes, "
                             f"got {len(body)}")
        from vaudio_torch.io.sources import parse_yuv420
        y, u, v = parse_yuv420(body, h, w, fmt)
        return {"y": y, "u": u, "v": v}
    raise ValueError(f"unknown fmt {fmt!r} (rgb24, i420 or nv12)")


def frame_structure_error(frame, cfg=None) -> Optional[str]:
    """Validate a pushed frame against what the pipeline can actually
    trace — network ingest must reject at the door anything that would
    otherwise raise at dispatch time and kill the producer (a pod loses
    EVERY slot to one such frame).  Checks: an (H, W, 3) numeric RGB
    array, or a planar-YUV dict with 2-D numeric y/u/v members whose
    chroma planes are the 4:2:0 half-size of y (the device-side path
    crops one-texel-larger chroma but broadcast-fails on anything
    smaller, vision.features.yuv420_mip_to_rgb_planes).  With ``cfg``, also
    checks the config can take the frame: YUV needs ``mip_level >= 1``,
    and the mip plane must still cover the ``grid_size`` cell grid.
    Returns an error message or None."""
    if isinstance(frame, dict):
        if not {"y", "u", "v"} <= set(frame) or any(
                np.asanyarray(frame[k]).ndim != 2 for k in ("y", "u", "v")):
            return ("planar-YUV frame needs 2-D 'y', 'u', 'v' members, "
                    f"got {[(k, np.asanyarray(v).shape) for k, v in frame.items()]}")
        y, u, v = (np.asanyarray(frame[k]) for k in ("y", "u", "v"))
        if not all(np.issubdtype(p.dtype, np.number) for p in (y, u, v)):
            return ("planar-YUV members must be numeric, got dtypes "
                    f"{[str(np.asanyarray(frame[k]).dtype) for k in ('y', 'u', 'v')]}")
        hc, wc = (y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2
        if u.shape != (hc, wc) or v.shape != (hc, wc):
            return (f"4:2:0 chroma planes for y{y.shape} must be "
                    f"({hc}, {wc}), got u{u.shape} v{v.shape}")
        if cfg is not None and cfg.mip_level < 1:
            return ("planar-YUV frames need mip_level >= 1 (the "
                    "device-side path pools half-resolution chroma at "
                    "level-1); send RGB to this config")
        h, w = y.shape
    else:
        arr = np.asanyarray(frame)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return f"frame must be (H, W, 3) RGB, got shape {arr.shape}"
        if not np.issubdtype(arr.dtype, np.number):
            return f"frame dtype must be numeric, got {arr.dtype}"
        h, w = arr.shape[:2]
    if cfg is not None and ((h >> cfg.mip_level) < cfg.grid_size
                            or (w >> cfg.mip_level) < cfg.grid_size):
        return (f"frame {h}x{w} is too small: the level-{cfg.mip_level} "
                f"mip ({h >> cfg.mip_level}x{w >> cfg.mip_level}) cannot "
                f"cover the {cfg.grid_size}x{cfg.grid_size} cell grid")
    return None


def handle_frame_post(handler, ps, validate, not_armed: str) -> None:
    """The shared ``POST .../frames`` ingest door (LiveServer root and
    PodServer per-slot): size-check, decode, validate, enqueue, reply.
    ``ps`` is the target :class:`vaudio_torch.io.PushSource` (None
    answers 409 with ``not_armed``); ``validate(frame) -> Optional[str]`` is
    the door's contract check."""
    from urllib.parse import parse_qs
    if ps is None:
        handler._json({"error": not_armed}, 409)
        return
    try:
        n = int(handler.headers.get("Content-Length", 0))
    except ValueError:
        handler._json({"error": "bad Content-Length header"}, 400)
        return
    if n > MAX_FRAME_BODY:
        handler._json({"error": f"frame body {n} bytes exceeds the "
                       f"{MAX_FRAME_BODY}-byte limit"}, 413)
        return
    query = {k: v[0] for k, v in parse_qs(
        handler.path.partition("?")[2]).items()}
    try:
        frame = decode_frame_body(handler.rfile.read(n), query)
    except ValueError as e:
        handler._json({"error": str(e)}, 400)
        return
    err = validate(frame)
    if err is not None:
        # Reject at the door: a queued contract-violating frame would
        # kill the producer (or dark the slot) at dispatch time.
        handler._json({"error": err}, 400)
        return
    try:
        ps.push(frame)
    except ValueError as e:                   # closed mid-request
        handler._json({"error": str(e)}, 409)
        return
    handler._json({"queued": ps.fill, "pushed": ps.pushed,
                   "dropped": ps.dropped})


def npz_bytes(save_fn) -> bytes:
    """Run a ``save_state``-style callable against an in-memory buffer
    (np.savez accepts file objects) and return the .npz bytes."""
    import io
    buf = io.BytesIO()
    save_fn(buf)
    return buf.getvalue()


def _wav_stream_header(sample_rate: float, channels: int) -> bytes:
    """A 16-bit WAV header for an unbounded live stream: RIFF/data sizes
    set to 0xFFFFFFFF, which players treat as 'read until EOF'."""
    import struct
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, channels,
                          int(round(sample_rate)),
                          int(round(sample_rate)) * channels * 2,
                          channels * 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def write_wav_stream(handler, sample_rate: float, channels: int,
                     quanta, stopped) -> None:
    """Stream float PCM quanta to an HTTP handler as a live 16-bit WAV
    until the iterator ends, the client leaves (Broken/Reset raised to
    the caller), or ``stopped`` is set.  Shared by the single-stream and
    pod panels — the body of their AVAudioSourceNode-equivalent pull."""
    handler.send_response(200)
    handler.send_header("Content-Type", "audio/wav")
    handler.send_header("Cache-Control", "no-store")
    handler.end_headers()
    handler.wfile.write(_wav_stream_header(sample_rate, channels))
    for quantum in quanta:
        pcm16 = (np.clip(quantum, -1.0, 1.0) * 32767.0).astype("<i2")
        handler.wfile.write(pcm16.tobytes())
        if stopped.is_set():
            return


class LiveServer:
    """Serve the live control/observability surface for an
    :class:`~vaudio_torch.api.Auralizer` (see module docstring).  Non-blocking:
    ``start()`` spins a daemon thread; ``stop()`` shuts the listener
    down.  ``port=0`` binds an ephemeral port (read :attr:`port`)."""

    def __init__(self, aur, host: str = "127.0.0.1", port: int = 0,
                 refresh_ms: int = 500, token: Optional[str] = None):
        self.aur = aur
        self.refresh_ms = int(refresh_ms)
        #: Optional bearer token (see :func:`check_auth`): when set,
        #: every endpoint requires it — production panels bound beyond
        #: localhost should set one.  An empty string means DISABLED
        #: (a cleared-but-set VAUDIO_TOKEN env var must not brick the
        #: panel with a credential nothing can send).
        self.token = token or None
        self._audio_lock = threading.Lock()   # one /audio.wav listener
        self._stopped = threading.Event()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet by default: per-request stderr lines would interleave
            # with the stream's own logging.
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, ctype: str, body: bytes,
                      extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._send(code, "application/json",
                           json.dumps(obj).encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if not check_auth(self, server.token):
                        return
                    if path == "/":
                        self._send(200, "text/html; charset=utf-8",
                                   server._page().encode())
                    elif path == "/params":
                        self._json(server._params_dict())
                    elif path == "/metrics":
                        self._json(server.aur.metrics)
                    elif path == "/metrics.prom":
                        # Prometheus scrape endpoint (production
                        # observability; same numbers as /metrics).
                        self._send(200,
                                   "text/plain; version=0.0.4",
                                   prometheus_text(
                                       server.aur.metrics).encode())
                    elif path == "/state.npz":
                        # Checkpoint download: the live DSP carry as the
                        # same .npz `save_state` writes (consistent
                        # snapshot under the carry lock) — ops can
                        # checkpoint a running stream over HTTP.
                        try:
                            body = npz_bytes(server.aur.save_state)
                        except ValueError as e:
                            # Frame-sized carry, no frame yet: a JSON
                            # 409 beats a dropped connection.
                            self._json({"error": str(e)}, 409)
                            return
                        self._send(200, "application/octet-stream",
                                   body,
                                   extra=(("Content-Disposition",
                                           'attachment; '
                                           'filename="state.npz"'),))
                    elif path.startswith("/debug/") and \
                            path.endswith(".png"):
                        name = path[len("/debug/"):-len(".png")]
                        try:
                            png = server._render_png(name)
                        except Exception as e:
                            # e.g. a malformed ingested frame that killed
                            # the stream but is still in last_frame: the
                            # view must degrade to an error body, not
                            # reset the socket on every poll tick.
                            self._json({"error":
                                        f"render {name!r} failed: {e}"},
                                       500)
                        else:
                            if png is None:
                                self._json({"error": f"no view {name!r} "
                                            "or no debug state yet"}, 404)
                            else:
                                self._send(200, "image/png", png)
                    elif path == "/push":
                        ps = server.aur.push_source
                        self._json({"armed": False} if ps is None
                                   else ps.state())
                    elif path == "/audio.wav":
                        server._stream_audio(self)
                    else:
                        self._json({"error": "not found"}, 404)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                # Same client-vanished guard as do_GET: the panel fires
                # un-awaited POSTs per slider event; a closed tab must
                # not dump socketserver tracebacks to stderr.
                try:
                    if not check_auth(self, server.token):
                        return
                    self._post()
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _post(self):
                path = self.path.split("?", 1)[0]
                if path == "/state.npz":
                    # Checkpoint restore: upload a `save_state` .npz
                    # carry; the next dispatch continues from it.
                    import io
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        server.aur.load_state(io.BytesIO(
                            self.rfile.read(n)))
                    except Exception as e:
                        self._json({"error": f"bad checkpoint: {e}"},
                                   400)
                        return
                    self._json({"restored": True})
                    return
                if path == "/frames":
                    # Network frame ingest (the push-model capture
                    # contract over HTTP, VisionEngine.swift:77-101):
                    # only meaningful when the stream's source is a
                    # PushSource.  A dead stream must answer 409, not
                    # keep queueing into a producer nobody runs.
                    aur = server.aur
                    if aur.failure is not None:
                        self._json({"error": "the stream has FAILED: "
                                    f"{aur.failure}"}, 409)
                        return
                    handle_frame_post(
                        self, aur.push_source, aur.frame_error,
                        not_armed="this stream's source is not "
                        "push-model; start it on a "
                        "vaudio_torch.io.PushSource")
                    return
                if path == "/push":
                    # Close the inbound push stream ({"close": true});
                    # arming happens at launch for a single stream.
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        self._json({"error": f"bad request: {e}"}, 400)
                        return
                    ps = server.aur.push_source
                    if ps is None:
                        self._json({"error": "source is not push-model"},
                                   409)
                        return
                    if not (isinstance(msg, dict) and msg.get("close")):
                        self._json({"error": "only {\"close\": true} is "
                                    "supported here (single-stream push "
                                    "sources are armed at launch)"}, 400)
                        return
                    ps.close()
                    self._json(ps.state())
                    return
                if path != "/params":
                    self._json({"error": "not found"}, 404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(msg, dict):
                        raise ValueError("expected a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json({"error": f"bad request: {e}"}, 400)
                    return
                warnings: list = []
                try:
                    applied = apply_control_message(
                        server.aur.params, msg, warn=warnings.append,
                        num_cells=server.aur.config.num_cells)
                except (TypeError, ValueError) as e:
                    self._json({"error": f"bad value: {e}"}, 400)
                    return
                self._json({"applied": applied, "warnings": warnings,
                            "params": server._params_dict()})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- content -----------------------------------------------------------

    def _page(self) -> str:
        # The page embeds the token it was fetched with: its own
        # fetch()/img/audio URLs carry ?token= (headers are not an
        # option for <img>/<audio> elements).
        from urllib.parse import quote
        qs = "" if self.token is None else f"?token={quote(self.token)}"
        return _PAGE.format(
            sliders=json.dumps([list(s) for s in _SLIDERS]),
            refresh_ms=self.refresh_ms,
            qs=qs, qs_amp=qs.replace("?", "&"))

    def _params_dict(self):
        p = self.aur.params
        out = {k: getattr(p, k) for k in CONTROLLABLE
               if k != "pan_angles"}
        pan = p.pan_angles
        out["pan_angles"] = (None if pan is None
                             else np.asarray(pan, np.float32).tolist())
        return out

    def _render_png(self, name: str) -> Optional[bytes]:
        from vaudio_torch.utils.render import (hue_matrix_image,
                                               input_preview_image,
                                               png_bytes, spectrum_image,
                                               waveform_image)
        dbg = self.aur.debug
        cfg = self.aur.config
        if name == "input":
            frame = getattr(self.aur._stream, "last_frame", None)
            return None if frame is None else \
                png_bytes(input_preview_image(frame))
        if name == "hue_matrix" and "hues" in dbg:
            return png_bytes(hue_matrix_image(dbg["hues"], cfg))
        if name == "spectrum" and dbg.get("spectrum") is not None:
            return png_bytes(spectrum_image(dbg["spectrum"], cfg))
        if name == "waveform" and dbg.get("pcm") is not None:
            return png_bytes(waveform_image(dbg["pcm"]))
        return None

    def _stream_audio(self, handler) -> None:
        """Chunked live WAV: pull 512-sample quanta at the hardware
        cadence (underruns emit silence — SoundEngine.swift:184-189) and
        push them to the client until it disconnects."""
        if not self._audio_lock.acquire(blocking=False):
            handler._json({"error": "audio stream busy (one listener "
                           "at a time)"}, 409)
            return
        try:
            cfg = self.aur.config
            # Always pace at the hardware cadence: the listener IS the
            # audio device here; free-running would drain the ring (and
            # zero-fill) at CPU speed.
            write_wav_stream(handler, cfg.sample_rate, cfg.channels,
                             self.aur.audio_stream(512, pace=True),
                             self._stopped)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            self._audio_lock.release()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LiveServer":
        if self._thread is not None:
            return self
        self._stopped.clear()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True, name="vaudio-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            # shutdown() waits on an event only serve_forever() sets —
            # calling it on a never-started server would block forever.
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/"
