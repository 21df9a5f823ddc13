"""Live HTTP observability + control panel for a serving pod — the
PyTorch port's copy of :mod:`vaudio.runtime.podserver`.

:class:`~vaudio_torch.runtime.multistream.MultiStreamAuralizer` packages N
concurrent streams behind one stream-batched step a tick; this module
gives that pod the same live surface the single-stream front door has
(:class:`~vaudio_torch.runtime.server.LiveServer`), scaled to N slots — the
reference's whole SwiftUI interaction model (sliders mutating published
params mid-run, SoundEngine.swift:66-75 / Views/ControlPanelView.swift:11-43;
continuously-redrawing views, Views/SpectrumView.swift:18,
Views/DebuggingView.swift:37-93; a pull-model speaker,
SoundEngine.swift:156-228) replicated *per serving slot*:

* ``GET /``                      — the pod panel: aggregate dispatch
  metrics + one card per slot (live views, sliders, audio element);
* ``GET /metrics``               — :meth:`MultiStreamAuralizer.metrics_dict`;
* ``GET /metrics.prom``          — the same in Prometheus text format
  (per-slot series labeled ``{slot="i"}``) for scraping;
* ``GET /state.npz`` / ``POST /state.npz`` — download / restore the
  pod checkpoint (every slot's DSP carry; shape-validated) over HTTP;
* ``POST /resize``               — elastic capacity: JSON
  ``{"n_streams": N}`` grows/shrinks the pod's slot count live
  (:meth:`MultiStreamAuralizer.resize`; new slots arrive dark and are
  armed via ``POST /slots/<i>/push``; the panel page reloads itself
  when the slot count changes);
* ``POST /slots/acquire``        — fleet allocation: lease a free slot
  (or grow the pod up to ``max_streams``) push-armed with a cold DSP
  carry; answers ``{"slot": i, "n_streams": n, ...push state}`` or 409
  at capacity.  Optional body ``{"maxsize", "when_empty", "reset"}``;
* ``POST /slots/<i>/release``    — end a lease: the slot's push stream
  closes/goes dark; optional body ``{"shrink": true}`` also resizes
  away the trailing run of free slots;
* ``GET /slots/<i>/params``      — slot ``i``'s live parameters;
* ``POST /slots/<i>/params``     — JSON updates for slot ``i`` (same
  validation as the single-stream panel; the producer stacks the values
  every dispatch, so an update applies on the next tick).  With a single
  shared ``LiveParams`` every slot POSTs to the same object — the
  response carries ``"shared": true`` so clients can reflect that.
  Setting/clearing ``pan_angles`` on ONE slot of a per-slot pod is
  refused (409): its presence must match across slots (the stacked
  params share one signature);
* ``POST /params``               — pod-level broadcast: the update is
  applied to EVERY slot, atomically w.r.t. the producer's param
  stacking — the way to set/clear ``pan_angles`` pod-wide;
* ``GET /slots/<i>/debug/hue_matrix.png`` / ``spectrum.png`` — rendered
  from the slot's row of the live DSP carry (always available);
* ``GET /slots/<i>/debug/waveform.png`` / ``input.png`` — the slot's
  last real output hop / last ingested-frame preview; populated while
  the pod runs with :attr:`MultiStreamAuralizer.observe` on (this
  server turns it on when it starts);
* ``POST /slots/<i>/push``       — arm slot ``i`` for network (push)
  ingest: frames then arrive over HTTP instead of from a pod-side file/
  device (the capture delegate's push contract, VisionEngine.swift:77-101,
  moved across the network).  Optional JSON body ``{"maxsize": 8,
  "when_empty": "hold"|"dark", "reset": false}``; ``{"close": true}``
  ends the slot's push stream (queued frames drain, then the slot goes
  dark and can be re-armed);
* ``GET /slots/<i>/push``        — the slot's push-queue state
  (``armed``/``fill``/``dropped``/``closed``);
* ``POST /slots/<i>/frames``     — push ONE frame to an armed slot: a
  self-describing ``.npy`` body, a planar-YUV ``.npz`` (members y/u/v),
  or raw ``rgb24``/``i420``/``nv12`` bytes with ``?w=&h=&fmt=`` params
  (:func:`vaudio_torch.runtime.server.decode_frame_body`).  The frame is
  validated against the pod's static shape/dtype contract BEFORE it is
  queued (a bad frame answers 400; it must not dark the slot).  A full
  queue drops its oldest frame — newest frames win, exactly the
  capture stack's ``alwaysDiscardsLateVideoFrames`` policy
  (CameraModel.swift:24);
* ``GET /slots/<i>/audio.wav``   — a live 16-bit WAV stream pulled from
  the slot's ring at the hardware cadence (one listener per slot).
  NOTE: any other consumer of that ring (:meth:`MultiStreamAuralizer.pull`)
  splits samples with the listener; such a consumer skips a slot while a
  listener holds it (see :meth:`audio_busy`, :meth:`drain_exclusive`).

Usage::

    pod = MultiStreamAuralizer(cfg, n_streams=8)
    server = pod.serve(port=8000)        # -> PodServer, non-blocking
    pod.start(sources)
    ...
    server.stop()

The pod runs on the card unless its engine was built with
``device="cpu"``; the server itself is host code.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vaudio_torch.runtime.control import (CONTROLLABLE,
                                          apply_control_message)
from vaudio_torch.runtime.server import _SLIDERS, check_auth

_PAGE = """<!doctype html><meta charset="utf-8">
<title>vaudio pod</title>
<style>
 body {{ font: 14px system-ui, sans-serif; background: #101014;
        color: #d8d8e0; margin: 1.5em; }}
 h1 {{ font-size: 1.2em; }} h2 {{ font-size: 1em; color: #9ab; }}
 .row {{ display: flex; gap: 1.5em; flex-wrap: wrap; }}
 .panel {{ background: #17171d; border-radius: 8px; padding: 1em; }}
 label {{ display: grid; grid-template-columns: 9em 11em 4.5em;
          align-items: center; gap: .5em; margin: .3em 0; }}
 output {{ font-variant-numeric: tabular-nums; color: #8fd; }}
 img {{ image-rendering: pixelated; border-radius: 4px; display: block;
        margin-top: .4em; }}
 pre {{ color: #9a9; font-size: 12px; }}
 details {{ margin-top: .5em; }}
</style>
<h1>vaudio — serving pod ({n_slots} slots)</h1>
<div class="panel"><h2>pod metrics</h2><pre id="agg">...</pre></div>
<div class="row" id="slots"></div>
<script>
const N = {n_slots};
const SLIDERS = {sliders};
const root = document.getElementById("slots");
for (let s = 0; s < N; s++) {{
  const card = document.createElement("div");
  card.className = "panel";
  card.innerHTML = `<h2>slot ${{s}}</h2>
   <div style="display:flex;gap:1em">
    <div><img id="input_${{s}}" width="160">
         <img id="hue_matrix_${{s}}" width="160"></div>
    <div><img id="spectrum_${{s}}" width="320">
         <img id="waveform_${{s}}" width="320"></div>
   </div>
   <audio controls preload="none" src="/slots/${{s}}/audio.wav{qs}"></audio>
   <details><summary>parameters</summary>
     <div id="sliders_${{s}}"></div></details>
   <pre id="m_${{s}}">...</pre>`;
  root.appendChild(card);
  fetch(`/slots/${{s}}/params{qs}`).then(r => r.json()).then(p => {{
    const box = document.getElementById(`sliders_${{s}}`);
    for (const [name, lo, hi, step] of SLIDERS) {{
      const l = document.createElement("label");
      l.innerHTML = `<span>${{name}}</span>` +
        `<input type=range min=${{lo}} max=${{hi}} step=${{step}} ` +
        `value="${{p[name]}}">` +
        `<output>${{Number(p[name]).toFixed(3)}}</output>`;
      box.appendChild(l);
      const inp = l.querySelector("input"), out = l.querySelector("output");
      inp.oninput = () => {{
        out.textContent = Number(inp.value).toFixed(3);
        fetch(`/slots/${{s}}/params{qs}`, {{method: "POST",
          body: JSON.stringify({{[name]: Number(inp.value)}})}});
      }};
    }}
  }});
}}
function tick() {{
  const t = Date.now();
  for (let s = 0; s < N; s++)
    for (const v of ["input", "hue_matrix", "spectrum", "waveform"])
      document.getElementById(`${{v}}_${{s}}`).src =
        `/slots/${{s}}/debug/${{v}}.png?t=${{t}}{qs_amp}`;
  fetch("/metrics{qs}").then(r => r.json()).then(m => {{
    if (m.n_streams !== N) {{ location.reload(); return; }}
    const slots = m.slots; delete m.slots;
    document.getElementById("agg").textContent =
      JSON.stringify(m, null, 1);
    for (let s = 0; s < N; s++)
      document.getElementById(`m_${{s}}`).textContent =
        JSON.stringify(slots[s], null, 1);
  }});
}}
tick(); setInterval(tick, {refresh_ms});
</script>
"""


class PodServer:
    """Serve the live observability/control surface for a
    :class:`~vaudio_torch.runtime.multistream.MultiStreamAuralizer` (see module
    docstring).  Non-blocking: ``start()`` spins a daemon thread and
    enables the pod's :attr:`~MultiStreamAuralizer.observe` state;
    ``port=0`` binds an ephemeral port (read :attr:`port`)."""

    def __init__(self, pod, host: str = "127.0.0.1", port: int = 0,
                 refresh_ms: int = 500, token: Optional[str] = None):
        self.pod = pod
        self.refresh_ms = int(refresh_ms)
        #: Optional bearer token (runtime.server.check_auth): when set,
        #: every endpoint requires it — production panels bound beyond
        #: localhost should set one.  An empty string means DISABLED
        #: (a cleared-but-set token must not brick the panel with a
        #: credential nothing can send).
        self.token = token or None
        self._audio_locks = [threading.Lock()
                             for _ in range(pod.n_streams)]
        self._locks_lock = threading.Lock()  # grows _audio_locks (resize)
        self._stopped = threading.Event()
        server = self

        class Handler(BaseHTTPRequestHandler):
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

            def _read_json(self) -> Optional[dict]:
                """Parse the request body as a JSON object; answers 400
                and returns None on anything else."""
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(msg, dict):
                        raise ValueError("expected a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json({"error": f"bad request: {e}"}, 400)
                    return None
                return msg

            def _slot(self, part: str) -> Optional[int]:
                try:
                    i = int(part)
                except ValueError:
                    return None
                return i if 0 <= i < server.pod.n_streams else None

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if not check_auth(self, server.token):
                        return
                    if path == "/":
                        self._send(200, "text/html; charset=utf-8",
                                   server._page().encode())
                        return
                    if path == "/metrics":
                        self._json(server.pod.metrics_dict())
                        return
                    if path == "/metrics.prom":
                        from vaudio_torch.runtime.server import \
                            prometheus_text
                        self._send(200, "text/plain; version=0.0.4",
                                   prometheus_text(
                                       server.pod.metrics_dict())
                                   .encode())
                        return
                    if path == "/state.npz":
                        # Pod checkpoint download (all slots' carries,
                        # consistent snapshot — runtime/checkpoint.py).
                        from vaudio_torch.runtime.server import npz_bytes
                        try:
                            body = npz_bytes(server.pod.save_state)
                        except ValueError as e:
                            # Frame-sized carry, no tick yet: a JSON
                            # 409 beats a dropped connection.
                            self._json({"error": str(e)}, 409)
                            return
                        self._send(200, "application/octet-stream",
                                   body,
                                   extra=(("Content-Disposition",
                                           'attachment; '
                                           'filename="state.npz"'),))
                        return
                    parts = path.strip("/").split("/")
                    if len(parts) >= 2 and parts[0] == "slots":
                        slot = self._slot(parts[1])
                        if slot is None:
                            self._json({"error": f"no slot {parts[1]!r}"},
                                       404)
                            return
                        rest = parts[2:]
                        if rest == ["params"]:
                            self._json(server._params_dict(slot))
                            return
                        if rest == ["push"]:
                            ps = server.pod.push_sources[slot]
                            self._json({"armed": False} if ps is None
                                       else ps.state())
                            return
                        if rest == ["audio.wav"]:
                            server._stream_audio(self, slot)
                            return
                        if (len(rest) == 2 and rest[0] == "debug"
                                and rest[1].endswith(".png")):
                            name = rest[1][:-len(".png")]
                            try:
                                png = server._render_png(slot, name)
                            except Exception as e:
                                self._json(
                                    {"error":
                                     f"render {name!r} failed: {e}"}, 500)
                                return
                            if png is None:
                                self._json({"error": f"no view {name!r} "
                                            "or no state yet"}, 404)
                            else:
                                self._send(200, "image/png", png)
                            return
                    self._json({"error": "not found"}, 404)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                # Same client-vanished guard as do_GET: panel sliders
                # fire un-awaited POSTs; a closed tab must not dump
                # socketserver tracebacks to the serving process stderr.
                try:
                    if not check_auth(self, server.token):
                        return
                    self._post()
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _post(self):
                path = self.path.split("?", 1)[0]
                if path == "/resize":
                    # Elastic capacity: resize the pod's slot count
                    # live (MultiStreamAuralizer.resize — applied at
                    # the producer's next dispatch boundary; new slots
                    # arrive dark, armed via POST /slots/<i>/push).
                    msg = self._read_json()
                    if msg is None:
                        return
                    try:
                        n = int(msg["n_streams"])
                    except (KeyError, TypeError, ValueError):
                        self._json({"error": "body must carry an "
                                    "integer 'n_streams'"}, 400)
                        return
                    try:
                        server.pod.resize(n)
                    except (TypeError, ValueError) as e:
                        self._json({"error": f"bad value: {e}"}, 400)
                        return
                    except TimeoutError as e:
                        self._json({"error": str(e)}, 503)
                        return
                    self._json({"n_streams": server.pod.n_streams})
                    return
                if path == "/params":
                    # Pod-level broadcast: apply one update to EVERY
                    # slot, atomically w.r.t. the producer's param
                    # stacking (params_lock) — the only safe way to
                    # set/clear pan_angles on a per-slot-params pod
                    # (presence must match across slots).
                    msg = self._read_json()
                    if msg is None:
                        return
                    warnings: list = []
                    targets = (server.pod.params[:1]
                               if server._params_shared()
                               else server.pod.params)
                    import dataclasses
                    try:
                        # Dry-run against a throwaway copy: a bad value
                        # must reject the WHOLE broadcast, never leave
                        # slots diverged mid-loop.
                        apply_control_message(
                            dataclasses.replace(targets[0]), msg,
                            warn=warnings.append,
                            num_cells=server.pod.cfg.num_cells)
                    except (TypeError, ValueError) as e:
                        self._json({"error": f"bad value: {e}"}, 400)
                        return
                    with server.pod.params_lock:
                        applied = sum(
                            apply_control_message(
                                p, msg, warn=lambda w: None,
                                num_cells=server.pod.cfg.num_cells)
                            for p in targets)
                    self._json({"applied": applied,
                                "slots_updated": len(targets),
                                "warnings": warnings,
                                "shared": server._params_shared()})
                    return
                if path == "/state.npz":
                    # Pod checkpoint restore (shape-validated against
                    # the config AND the pod size).
                    import io
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        server.pod.load_state(io.BytesIO(
                            self.rfile.read(n)))
                    except Exception as e:
                        self._json({"error": f"bad checkpoint: {e}"},
                                   400)
                        return
                    self._json({"restored": True})
                    return
                if path == "/slots/acquire":
                    # Fleet allocation: lease a free slot (or grow the
                    # pod up to max_streams) and arm it for push ingest
                    # — clients need not track slot indices themselves.
                    msg = self._read_json()
                    if msg is None:
                        return
                    try:
                        slot, ps = server.pod.acquire_slot(
                            maxsize=int(msg.get("maxsize", 8)),
                            when_empty=msg.get("when_empty", "hold"),
                            reset_carry=bool(msg.get("reset", True)))
                    except TimeoutError as e:     # resize didn't land
                        self._json({"error": str(e)}, 503)
                        return
                    except RuntimeError as e:     # at capacity
                        self._json({"error": str(e)}, 409)
                        return
                    except (TypeError, ValueError) as e:
                        self._json({"error": f"bad value: {e}"}, 400)
                        return
                    self._json({"slot": slot,
                                "n_streams": server.pod.n_streams,
                                **ps.state()})
                    return
                parts = path.strip("/").split("/")
                if (len(parts) != 3 or parts[0] != "slots"
                        or parts[2] not in ("params", "push", "frames",
                                            "release")):
                    self._json({"error": "not found"}, 404)
                    return
                slot = self._slot(parts[1])
                if slot is None:
                    self._json({"error": f"no slot {parts[1]!r}"}, 404)
                    return
                if parts[2] == "release":
                    msg = self._read_json()
                    if msg is None:
                        return
                    try:
                        server.pod.release_slot(
                            slot, shrink=bool(msg.get("shrink", False)))
                    except TimeoutError as e:   # shrink didn't land
                        self._json({"error": str(e)}, 503)
                        return
                    except IndexError as e:     # shrunk under us
                        self._json({"error": str(e)}, 404)
                        return
                    self._json({"released": slot,
                                "n_streams": server.pod.n_streams})
                    return
                if parts[2] == "push":
                    self._post_push(slot)
                    return
                if parts[2] == "frames":
                    self._post_frame(slot)
                    return
                msg = self._read_json()
                if msg is None:
                    return
                if "pan_angles" in msg and not server._params_shared():
                    # Cross-slot invariant (multistream._stack_params):
                    # optional array-valued fields must be set on ALL
                    # slots or none — the stacked params share one
                    # signature.  Accepting a one-slot flip here would
                    # 200 and then kill the whole pod at the next
                    # dispatch.
                    want = msg["pan_angles"] is not None
                    mismatched = [
                        j for j in range(server.pod.n_streams)
                        if j != slot
                        and (server.pod.params[j].pan_angles
                             is not None) != want]
                    if mismatched:
                        self._json(
                            {"error":
                             "pan_angles must be set on ALL slots or "
                             "none (the pod stacks params into one jit "
                             f"signature); slots {mismatched} currently "
                             f"have pan_angles "
                             f"{'unset' if want else 'set'} — POST "
                             "/params to set/clear it on every slot "
                             "atomically"}, 409)
                        return
                warnings: list = []
                try:
                    applied = apply_control_message(
                        server.pod.params[slot], msg,
                        warn=warnings.append,
                        num_cells=server.pod.cfg.num_cells)
                except (TypeError, ValueError) as e:
                    self._json({"error": f"bad value: {e}"}, 400)
                    return
                self._json({"applied": applied, "warnings": warnings,
                            "shared": server._params_shared(),
                            "params": server._params_dict(slot)})

            def _post_push(self, slot: int) -> None:
                """Arm/close push-model ingest for one slot (module
                docstring, POST /slots/<i>/push)."""
                msg = self._read_json()
                if msg is None:
                    return
                pod = server.pod
                if msg.get("close"):
                    ps = pod.push_sources[slot]
                    if ps is None:
                        self._json({"error": f"slot {slot} is not "
                                    "push-armed"}, 404)
                        return
                    ps.close()
                    self._json(ps.state())
                    return
                when_empty = msg.get("when_empty", "hold")
                if when_empty == "block":
                    # A blocking push slot would stall the pod's lockstep
                    # tick for every other slot.
                    self._json({"error": "when_empty='block' is not "
                                "allowed on a pod slot (it would block "
                                "the whole batch); use 'hold' or "
                                "'dark'"}, 400)
                    return
                try:
                    ps = pod.arm_push(
                        slot, maxsize=int(msg.get("maxsize", 8)),
                        when_empty=when_empty,
                        reset_carry=bool(msg.get("reset", False)))
                except (TypeError, ValueError) as e:
                    self._json({"error": f"bad value: {e}"}, 400)
                    return
                self._json(ps.state())

            def _post_frame(self, slot: int) -> None:
                """Push one frame to an armed slot (module docstring,
                POST /slots/<i>/frames)."""
                from vaudio_torch.runtime.server import handle_frame_post
                handle_frame_post(
                    self, server.pod.push_sources[slot],
                    server.pod.check_frame,
                    not_armed=f"slot {slot} is not push-armed; POST "
                    f"/slots/{slot}/push first")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- content -----------------------------------------------------------

    def _page(self) -> str:
        # The page embeds the token it was fetched with (same contract
        # as the single-stream panel).
        from urllib.parse import quote
        qs = "" if self.token is None else f"?token={quote(self.token)}"
        return _PAGE.format(
            n_slots=self.pod.n_streams,
            sliders=json.dumps([list(s) for s in _SLIDERS]),
            refresh_ms=self.refresh_ms,
            qs=qs, qs_amp=qs.replace("?", "&"))

    def _params_shared(self) -> bool:
        return len(set(map(id, self.pod.params))) == 1

    def _params_dict(self, slot: int):
        p = self.pod.params[slot]
        out = {k: getattr(p, k) for k in CONTROLLABLE
               if k != "pan_angles"}
        pan = p.pan_angles
        out["pan_angles"] = (None if pan is None
                             else np.asarray(pan, np.float32).tolist())
        out["shared"] = self._params_shared()
        return out

    def _render_png(self, slot: int, name: str) -> Optional[bytes]:
        from vaudio_torch.utils.render import (hue_matrix_image, png_bytes,
                                               spectrum_image,
                                               waveform_image)
        pod = self.pod
        if name == "input":
            img = pod.last_preview[slot]
            return None if img is None else png_bytes(img)
        if name == "waveform":
            pcm = pod.last_pcm[slot]
            return None if pcm is None else png_bytes(waveform_image(pcm))
        if name in ("hue_matrix", "spectrum"):
            # Rendered from the slot's row of the live batched DSP carry
            # (a consistent host snapshot of every slot's carry).
            try:
                carry = pod.snapshot_carry()
            except ValueError:          # frame-sized carry, no tick yet
                return None
            if name == "hue_matrix":
                if not hasattr(carry, "hues"):
                    return None         # per-pixel family: no cell hues
                return png_bytes(hue_matrix_image(carry.hues[slot],
                                                  pod.cfg))
            return png_bytes(spectrum_image(carry.prev_spectrum[slot],
                                            pod.cfg))
        return None

    # -- audio --------------------------------------------------------------

    def _audio_lock(self, slot: int) -> threading.Lock:
        """Per-slot audio lock, growing the list on demand — an elastic
        :meth:`MultiStreamAuralizer.resize` can add slots after this
        server was built."""
        with self._locks_lock:
            while len(self._audio_locks) <= slot:
                self._audio_locks.append(threading.Lock())
            return self._audio_locks[slot]

    def audio_busy(self, slot: int) -> bool:
        """True while a ``/slots/<slot>/audio.wav`` listener holds the
        slot's ring.  Other ring consumers (a WAV drain) should
        skip the slot while busy — concurrent pulls split samples.
        NOTE: a probe is only a snapshot; to actually pull without
        racing a connecting listener use :meth:`drain_exclusive`."""
        lock = self._audio_lock(slot)
        if lock.acquire(blocking=False):
            lock.release()
            return False
        return True

    def drain_exclusive(self, slot: int, fn):
        """Run ``fn()`` while holding ``slot``'s audio lock (the same
        lock a ``/slots/<slot>/audio.wav`` listener takes), so an
        external ring consumer cannot interleave pulls with a listener
        that connects mid-drain.  Non-blocking: returns ``fn()``'s
        result, or ``None`` when a listener currently holds the slot."""
        lock = self._audio_lock(slot)
        if not lock.acquire(blocking=False):
            return None
        try:
            return fn()
        finally:
            lock.release()

    def _stream_audio(self, handler, slot: int) -> None:
        """Chunked live WAV for one slot: pull 512-sample quanta at the
        hardware cadence (underruns emit silence per the real-time
        contract, SoundEngine.swift:184-189) until the client leaves."""
        lock = self._audio_lock(slot)
        if not lock.acquire(blocking=False):
            handler._json({"error": f"slot {slot} audio stream busy "
                           "(one listener per slot)"}, 409)
            return
        try:
            cfg = self.pod.cfg

            def quanta(quantum=512):           # per-channel samples
                period = quantum / cfg.sample_rate
                next_t = time.monotonic()
                while True:
                    now = time.monotonic()
                    if now < next_t:
                        time.sleep(next_t - now)
                    next_t = max(next_t + period, time.monotonic())
                    try:
                        if slot >= self.pod.n_streams:
                            return   # slot removed by an elastic shrink
                        yield self.pod.pull(slot, quantum * cfg.channels)
                    except IndexError:
                        return       # shrink landed between check and pull

            from vaudio_torch.runtime.server import write_wav_stream
            write_wav_stream(handler, cfg.sample_rate, cfg.channels,
                             quanta(), self._stopped)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            lock.release()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "PodServer":
        if self._thread is not None:
            return self
        self.pod.observe = True
        self._stopped.clear()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True,
                                        name="vaudio-pod-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        self.pod.observe = False     # hot path stops rendering previews
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
