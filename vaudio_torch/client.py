"""Programmatic clients for the vaudio serving surfaces — the PyTorch
port's copy of :mod:`vaudio.client`.

The serving front doors (``Auralizer.serve``,
:class:`vaudio_torch.runtime.server.LiveServer`;
``MultiStreamAuralizer.serve``,
:class:`vaudio_torch.runtime.podserver.PodServer`) speak plain HTTP/JSON
so any tool can drive them; besides the frame pusher
(:func:`vaudio_torch.io.push.push_frames`), this module is the full
client half: typed wrappers over every panel endpoint, so remote
control/observability needs no hand-rolled urllib.
It is the network equivalent of the reference app driving its engine
through published properties and pull callbacks
(Views/ControlPanelView.swift:11-43 -> SoundEngine.swift:66-75 sliders;
SoundEngine.swift:156-228 the pull-model speaker) — from another
process or machine.

Pure host-side: numpy + urllib only, it makes no tensor and needs no
card — a client can run on a laptop against a pod on a GPU host.  It
speaks the same protocol as the JAX package's servers and clients, so
either package's client drives either package's server.

    from vaudio_torch.client import PodClient

    pod = PodClient("http://gpu-host:8000")
    with pod.lease(when_empty="dark") as slot:   # fleet allocation
        for frame in frames:
            slot.push(frame)
        slot.set_params(stereo_width=0.5)        # live, next tick
        pcm = slot.record(2.0)                   # pull-model audio

    print(pod.metrics()["aggregate_fps"])

:class:`StreamClient` is the same surface for a single-stream panel
(``Auralizer.serve``).  Error contract: any non-2xx panel answer
raises :class:`VaudioHTTPError` carrying the HTTP status and the
server's JSON ``error`` message.
"""

from __future__ import annotations

import json
import struct
import time
import urllib.error
import urllib.request
from typing import Iterator, Optional

import numpy as np

from vaudio_torch.io.push import encode_frame
from vaudio_torch.runtime.ingest import host_dtype

__all__ = ["VaudioHTTPError", "AudioStream", "StreamClient",
           "PodClient", "PodSlot", "FleetClient", "frame_sig_json"]


def frame_sig_json(frame) -> dict:
    """A frame's static-contract signature in the pods' advertised
    format (``frame_sig`` in the pod metrics): shape plus the dtype the
    pod's host dtype rule (:func:`~vaudio_torch.runtime.ingest.host_dtype`)
    gives it — RGB arrays: uint8 passes through, everything else becomes
    float32; planar-YUV dict planes keep their dtype VERBATIM.
    Shape-aware fleet placement compares these directly
    (:meth:`FleetClient.acquire` ``frame=``)."""
    if isinstance(frame, dict):
        return {"planes": {
            k: {"shape": list(np.asarray(v).shape),
                "dtype": str(np.asarray(v).dtype)}
            for k, v in sorted(frame.items())}}
    a = np.asarray(frame)
    return {"shape": list(a.shape), "dtype": str(host_dtype(a.dtype))}


class VaudioHTTPError(RuntimeError):
    """A vaudio panel answered non-2xx.  ``status`` is the HTTP code,
    ``message`` the server's JSON ``error`` body (or raw text)."""

    def __init__(self, status: int, message: str, url: str):
        super().__init__(f"{url} answered {status}: {message}")
        self.status = int(status)
        self.message = message
        self.url = url


class _PanelClient:
    """Plumbing shared by the stream and pod clients: request/JSON
    helpers plus the endpoints both panels serve (metrics, Prometheus
    scrape, checkpoint up/download).

    ``retries``/``retry_wait`` make every request resilient to
    TRANSIENT failures — connection refused/reset (a pod restarting
    behind the same address) and 503 answers (a resize momentarily
    wedging the producer).  Real rejections (4xx) never retry.  Off by
    default; frame pushes are safe to retry (a duplicated frame is a
    repeat of the newest-wins queue's normal behavior)."""

    def __init__(self, url: str, timeout: float = 30.0,
                 retries: int = 0, retry_wait: float = 0.5,
                 token: Optional[str] = None):
        self.url = url.rstrip("/")
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.retry_wait = float(retry_wait)
        #: Bearer token for panels started with ``serve(token=...)`` —
        #: sent as ``Authorization: Bearer`` on every request.  Empty
        #: string = no token (matches the servers' disabled semantics).
        self.token = token or None

    # -- plumbing ------------------------------------------------------------

    def _open(self, path: str, data: Optional[bytes] = None,
              ctype: Optional[str] = None, method: Optional[str] = None,
              idempotent: bool = True, timeout: Optional[float] = None):
        """Open ``path`` and return the live response object (caller
        closes); non-2xx raises :class:`VaudioHTTPError`.  Transient
        failures retry per the constructor's ``retries``.

        ``idempotent=False`` (the acquire path) narrows the retried
        class to failures where the server provably did NOT apply the
        request: connection REFUSED (it never arrived) and 503 (the
        server answered "not applied").  A timeout or mid-flight reset
        on a non-idempotent request is re-raised — the first send may
        have been processed, and re-sending would double-apply (e.g.
        grant two leases)."""
        url = self.url + path
        headers = {"Content-Type": ctype} if ctype else {}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            url, data=data,
            method=method or ("POST" if data is not None else "GET"),
            headers=headers)
        for attempt in range(self.retries + 1):
            try:
                return urllib.request.urlopen(
                    req, timeout=self.timeout if timeout is None
                    else timeout)
            except urllib.error.HTTPError as e:
                body = e.read().decode(errors="replace")
                try:
                    body = json.loads(body).get("error", body)
                except (ValueError, AttributeError):
                    pass
                err = VaudioHTTPError(e.code, body, url)
                if e.code != 503 or attempt == self.retries:
                    raise err from None
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # Connection refused/reset/timeout: the transient class.
                refused = isinstance(getattr(e, "reason", e),
                                     ConnectionRefusedError)
                if attempt == self.retries or not (idempotent
                                                   or refused):
                    raise
            time.sleep(self.retry_wait)

    def _bytes(self, path: str, data: Optional[bytes] = None,
               ctype: Optional[str] = None,
               idempotent: bool = True,
               timeout: Optional[float] = None) -> bytes:
        with self._open(path, data, ctype,
                        idempotent=idempotent, timeout=timeout) as r:
            return r.read()

    def _json(self, path: str, obj: Optional[dict] = None,
              idempotent: bool = True,
              timeout: Optional[float] = None) -> dict:
        data = None if obj is None else json.dumps(obj).encode()
        ctype = None if obj is None else "application/json"
        return json.loads(self._bytes(path, data, ctype,
                                      idempotent=idempotent,
                                      timeout=timeout))

    # -- endpoints both panels serve ------------------------------------------

    def metrics(self, timeout: Optional[float] = None) -> dict:
        """The live metrics surface (``GET /metrics``); ``timeout``
        overrides the client default for this one poll."""
        return self._json("/metrics", timeout=timeout)

    def metrics_prom(self) -> str:
        """Prometheus text exposition (``GET /metrics.prom``)."""
        return self._bytes("/metrics.prom").decode()

    def save_state(self, path: Optional[str] = None) -> bytes:
        """Download the live DSP-carry checkpoint (``GET /state.npz``;
        the over-HTTP ``save_state``).  Returns the ``.npz`` bytes;
        ``path`` additionally writes them to disk."""
        body = self._bytes("/state.npz")
        if path is not None:
            with open(path, "wb") as f:
                f.write(body)
        return body

    def load_state(self, src) -> dict:
        """Restore a checkpoint into the running deployment (``POST
        /state.npz``; shape-validated server-side).  ``src`` is ``.npz``
        bytes or a path."""
        if isinstance(src, (bytes, bytearray)):
            body = bytes(src)
        else:
            with open(src, "rb") as f:
                body = f.read()
        return self._post_raw("/state.npz", body,
                              "application/octet-stream")

    def _post_raw(self, path: str, data: bytes, ctype: str) -> dict:
        """POST a non-JSON body, decode the JSON answer."""
        return json.loads(self._bytes(path, data, ctype))

    # -- live audio (the pull-model speaker, over HTTP) ------------------------

    def _audio(self, path: str, chunk_samples: int = 2048) -> "AudioStream":
        """Open a live ``audio.wav`` endpoint and parse its header (the
        panels emit an unbounded WAV: RIFF sizes 0xFFFFFFFF =
        read-until-EOF).  Returns an :class:`AudioStream` exposing the
        stream's ``sample_rate``/``channels`` and float32 PCM chunks."""
        resp = self._open(path)
        header = resp.read(44)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            resp.close()
            raise VaudioHTTPError(200, "not a WAV stream",
                                  self.url + path)
        channels, rate = struct.unpack("<HI", header[22:28])
        return AudioStream(resp, int(rate), int(channels),
                           chunk_samples)

    def _record(self, path: str, seconds: float) -> np.ndarray:
        """Pull ``seconds`` of live audio (wall-clock paced server-side
        at the hardware cadence; underruns arrive as silence, the
        real-time contract of SoundEngine.swift:184-189).  Returns
        float32 ``[n]`` (mono) or ``[n, channels]``."""
        with self._audio(path) as stream:
            return stream.record(seconds)


class AudioStream:
    """A live panel audio stream (``GET .../audio.wav``), header already
    parsed: ``sample_rate``/``channels`` plus an iterator of float32
    PCM chunks ``[chunk_samples, channels]``.  Close (or use as a
    context manager) to release the slot's one-listener lock."""

    def __init__(self, resp, sample_rate: int, channels: int,
                 chunk_samples: int = 2048):
        self._resp = resp
        self.sample_rate = sample_rate
        self.channels = channels
        self.chunk_samples = int(chunk_samples)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        """Drop the connection.  NOTE: the server notices the
        disconnect (and frees the slot's one-listener lock) on its
        NEXT paced write, so an immediate reopen can briefly answer
        409 — retry after ~the audio quantum."""
        self._resp.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        bytes_per = self.channels * 2
        want = self.chunk_samples * bytes_per
        while True:
            buf = b""
            while len(buf) < want:
                got = self._resp.read(want - len(buf))
                if not got:
                    break
                buf += got
            if not buf:
                return
            n = len(buf) - len(buf) % bytes_per
            pcm = (np.frombuffer(buf[:n], "<i2")
                   .astype(np.float32) / 32767.0)
            yield pcm.reshape(-1, self.channels)
            if n < want:
                return

    def record(self, seconds: float) -> np.ndarray:
        """Collect ``seconds`` of PCM (wall-clock: the server paces at
        the hardware cadence).  Shape ``[n]`` mono / ``[n, ch]``."""
        want = int(round(seconds * self.sample_rate))
        parts, got = [], 0
        for chunk in self:
            parts.append(chunk)
            got += len(chunk)
            if got >= want:
                break
        pcm = (np.concatenate(parts)[:want] if parts
               else np.zeros((0, self.channels), np.float32))
        return pcm[:, 0] if self.channels == 1 else pcm


class StreamClient(_PanelClient):
    """Client for a single-stream live panel (``Auralizer.serve``,
    :class:`vaudio_torch.runtime.server.LiveServer`).  See the module
    docstring for the error contract."""

    def params(self) -> dict:
        """The stream's live parameters (``GET /params``)."""
        return self._json("/params")

    def set_params(self, **updates) -> dict:
        """Mutate live parameters mid-run (``POST /params`` — applied on
        the next frame; the ControlPanelView slider surface).
        Returns the server's answer (``applied``/``warnings``/new
        params)."""
        return self._json("/params", updates)

    def push(self, frame) -> dict:
        """Push one frame into a push-fed stream (``POST
        /frames``): an RGB array or a planar-YUV dict."""
        body, ctype = encode_frame(frame)
        return self._post_raw("/frames", body, ctype)

    def push_state(self) -> dict:
        """The inbound push queue's state (``GET /push``)."""
        return self._json("/push")

    def close_push(self) -> dict:
        """End the inbound push stream (``POST /push {"close": true}``):
        queued frames drain, then the stream exhausts."""
        return self._json("/push", {"close": True})

    def view(self, name: str = "hue_matrix") -> bytes:
        """One live debug view as PNG bytes (``GET /debug/<name>.png``;
        names: ``hue_matrix``, ``spectrum``, ``waveform``, ``input``,
        ``mode_h``/``mode_s``/``mode_i`` ...)."""
        return self._bytes(f"/debug/{name}.png")

    def audio(self, chunk_samples: int = 2048) -> AudioStream:
        """Open the live WAV stream (``GET /audio.wav``) —
        an :class:`AudioStream` of float32 PCM chunks (one listener at
        a time; close it to release)."""
        return self._audio("/audio.wav", chunk_samples)

    def record(self, seconds: float) -> np.ndarray:
        """Pull ``seconds`` of live audio from the stream's speaker
        door.  Shape ``[n]`` mono / ``[n, 2]`` stereo."""
        return self._record("/audio.wav", seconds)


class PodSlot:
    """A handle on one serving-pod slot: the per-slot endpoints of
    :class:`~vaudio_torch.runtime.podserver.PodServer`, bound to an index.
    Obtained from :meth:`PodClient.slot`, :meth:`PodClient.acquire`, or
    :meth:`PodClient.lease` (the context-managed lease)."""

    def __init__(self, client: "PodClient", index: int):
        self.client = client
        self.index = int(index)
        self._prefix = f"/slots/{self.index}"

    def __repr__(self):
        return f"PodSlot({self.index} @ {self.client.url})"

    def params(self) -> dict:
        return self.client._json(f"{self._prefix}/params")

    def set_params(self, **updates) -> dict:
        """Live per-slot parameters (``POST /slots/<i>/params``).  Note
        setting/clearing ``pan_angles`` on ONE slot answers 409 — use
        :meth:`PodClient.broadcast_params` (the stacked params share one
        signature across slots)."""
        return self.client._json(f"{self._prefix}/params", updates)

    def arm_push(self, maxsize: int = 8, when_empty: str = "hold",
                 reset: bool = False) -> dict:
        """Arm the slot for network ingest (``POST /slots/<i>/push``)."""
        return self.client._json(
            f"{self._prefix}/push",
            {"maxsize": maxsize, "when_empty": when_empty,
             "reset": reset})

    def push(self, frame) -> dict:
        """Push one frame (``POST /slots/<i>/frames``); the slot must be
        push-armed (a lease from :meth:`PodClient.acquire` already is)."""
        body, ctype = encode_frame(frame)
        return self.client._post_raw(f"{self._prefix}/frames",
                                     body, ctype)

    def push_state(self) -> dict:
        return self.client._json(f"{self._prefix}/push")

    def close_push(self) -> dict:
        return self.client._json(f"{self._prefix}/push", {"close": True})

    def release(self, shrink: bool = False) -> dict:
        """End this slot's lease (``POST /slots/<i>/release``);
        ``shrink=True`` also resizes away trailing free capacity."""
        return self.client._json(f"{self._prefix}/release",
                                 {"shrink": shrink})

    def metrics(self) -> dict:
        """This slot's row of the pod metrics.  Raises
        :class:`VaudioHTTPError` (404) when the slot no longer exists
        (an elastic shrink landed) — the same contract as every other
        method on a stale handle."""
        slots = self.client.metrics()["slots"]
        if not 0 <= self.index < len(slots):
            raise VaudioHTTPError(
                404, f"no slot {self.index} (pod now has "
                f"{len(slots)} slots)", self.client.url + self._prefix)
        return slots[self.index]

    def view(self, name: str = "hue_matrix") -> bytes:
        """A live per-slot view as PNG bytes (``hue_matrix``,
        ``spectrum``, ``waveform``, ``input``)."""
        return self.client._bytes(f"{self._prefix}/debug/{name}.png")

    def audio(self, chunk_samples: int = 2048) -> AudioStream:
        """Open the slot's live WAV stream — an :class:`AudioStream` of
        float32 PCM chunks (one listener per slot; 409 while another
        holds it)."""
        return self.client._audio(f"{self._prefix}/audio.wav",
                                  chunk_samples)

    def record(self, seconds: float) -> np.ndarray:
        """Pull ``seconds`` of this slot's live audio."""
        return self.client._record(f"{self._prefix}/audio.wav", seconds)


class PodClient(_PanelClient):
    """Client for a serving-pod panel (``MultiStreamAuralizer.serve``,
    :class:`~vaudio_torch.runtime.podserver.PodServer`): fleet allocation
    (acquire/release leases), elastic resize, pod-wide parameter
    broadcast, and per-slot handles.  See the module docstring."""

    @property
    def n_streams(self) -> int:
        """The pod's LIVE slot count (elastic — see :meth:`resize`)."""
        return int(self.metrics()["n_streams"])

    def slot(self, index: int) -> PodSlot:
        """A handle on slot ``index`` (no lease implied)."""
        return PodSlot(self, index)

    def slots(self) -> list:
        """Handles on every current slot."""
        return [PodSlot(self, i) for i in range(self.n_streams)]

    def resize(self, n_streams: int) -> int:
        """Elastic capacity (``POST /resize``): grow/shrink the live
        pod's slot count; returns the applied count."""
        return int(self._json("/resize",
                              {"n_streams": int(n_streams)})["n_streams"])

    def acquire(self, maxsize: int = 8, when_empty: str = "hold",
                reset: bool = True) -> PodSlot:
        """Lease a free slot (``POST /slots/acquire``): reuses a free
        slot or grows the pod up to its ``max_streams``; the slot comes
        back push-armed with a cold DSP carry.  Raises
        :class:`VaudioHTTPError` (409) at capacity.  Prefer
        :meth:`lease` for scope-bound release."""
        resp = self._json("/slots/acquire",
                          {"maxsize": maxsize, "when_empty": when_empty,
                           "reset": reset},
                          idempotent=False)   # a retried acquire that
        # actually landed would grant (and leak) a second lease; only
        # connection-refused / 503 re-send (see _open).
        return PodSlot(self, resp["slot"])

    def lease(self, maxsize: int = 8, when_empty: str = "hold",
              reset: bool = True, shrink: bool = False):
        """Context-managed :meth:`acquire`: releases the slot on exit
        (even on error), with optional trailing ``shrink``.

            with pod.lease(when_empty="dark") as slot:
                for f in frames: slot.push(f)
        """
        return _LeaseContext(
            lambda: self.acquire(maxsize=maxsize, when_empty=when_empty,
                                 reset=reset), shrink)

    def broadcast_params(self, **updates) -> dict:
        """Apply one parameter update to EVERY slot atomically (``POST
        /params``) — the only way to set/clear ``pan_angles`` pod-wide."""
        return self._json("/params", updates)


class _LeaseContext:
    """Shared lease context manager (:meth:`PodClient.lease`,
    :meth:`FleetClient.lease`): acquire on enter, release on exit.  A
    failed release never masks the body's exception; with a clean body
    it is re-raised (the caller must know the lease is still held)."""

    def __init__(self, acquire_fn, shrink: bool):
        self._acquire = acquire_fn
        self._shrink = shrink

    def __enter__(self) -> "PodSlot":
        self.slot = self._acquire()
        return self.slot

    def __exit__(self, exc_type, *exc):
        try:
            self.slot.release(shrink=self._shrink)
        except VaudioHTTPError:
            pass            # pod shrank/stopped under us: lease gone
        except Exception:
            if exc_type is None:
                raise       # clean body, failed release: surface it
        return False


class FleetClient:
    """Lease placement across a FLEET of serving pods (one per GPU
    host, each a served ``MultiStreamAuralizer``): :meth:`acquire` picks
    the pod with the most capacity and leases there, so callers scale
    past one pod's ``max_streams`` without tracking hosts themselves.

        fleet = FleetClient(["http://gpu-a:8000", "http://gpu-b:8000"])
        with fleet.lease(when_empty="dark") as slot:
            for f in frames: slot.push(f)      # slot.client is the pod

    Placement: pods are tried in descending capacity order — free slots
    first, then growth headroom to ``max_streams`` (both read from one
    ``/metrics`` poll; an unbounded pod sorts as infinite headroom) —
    falling through 409s/unreachable pods to the next.  Raises the last
    error when every pod is at capacity or down.  Pure host-side, like
    the rest of this module."""

    def __init__(self, urls, timeout: float = 30.0, retries: int = 0,
                 retry_wait: float = 0.5, token: Optional[str] = None,
                 placement_timeout: float = 5.0):
        if not urls:
            raise ValueError("FleetClient needs at least one pod URL")
        #: One :class:`PodClient` per pod, in the order given.
        self.pods = [PodClient(u, timeout=timeout, retries=retries,
                               retry_wait=retry_wait, token=token)
                     for u in urls]
        #: Timeout for the per-acquire capacity polls — short on
        #: purpose: a blackholed pod must cost seconds per placement,
        #: not the full client timeout.
        self.placement_timeout = min(float(placement_timeout),
                                     float(timeout))

    def metrics(self, timeout: Optional[float] = None) -> list:
        """Per-pod metrics, ``None`` for unreachable pods."""
        out = []
        for pod in self.pods:
            try:
                out.append(pod.metrics(timeout=timeout))
            except Exception:
                out.append(None)
        return out

    def _capacity_order(self, frame=None):
        """REACHABLE pods sorted most-capacity-first (free slots, then
        max_streams headroom).  Pods whose short capacity poll failed
        are excluded from placement — trying an acquire on a blackholed
        pod would block the full client timeout; if every poll failed,
        all pods are returned in order as the last-ditch attempt.

        With ``frame``, placement is SHAPE-AWARE: pods advertising a
        frame contract (``frame_sig``) that mismatches the frame are
        excluded (a pod serves one static shape); pods with no
        established contract yet remain eligible (they will adopt the
        client's shape)."""
        want = None if frame is None else frame_sig_json(frame)
        polls = self.metrics(self.placement_timeout)
        ranked, reachable, wrong_shape = [], 0, 0
        for i, (pod, m) in enumerate(zip(self.pods, polls)):
            if m is None:
                continue
            reachable += 1
            sig = m.get("frame_sig")
            if want is not None and sig is not None and sig != want:
                wrong_shape += 1     # wrong-resolution pod
                continue
            cap = m.get("max_streams")
            headroom = (float("inf") if cap is None
                        else cap - m.get("n_streams", 0))
            ranked.append(((float(m.get("free_slots", 0)), headroom),
                           i, pod))
        ranked.sort(key=lambda t: (t[0], -t[1]), reverse=True)
        if ranked:
            return [pod for _, _, pod in ranked]
        if reachable and wrong_shape == reachable:
            # Every successfully-polled pod serves another shape — but
            # a pod whose poll transiently failed might serve this one;
            # attempt those before declaring the shape unserved
            # ([] => the caller raises the shape error).
            return [pod for pod, m in zip(self.pods, polls)
                    if m is None]
        return list(self.pods)       # every poll failed: last-ditch

    def acquire(self, maxsize: int = 8, when_empty: str = "hold",
                reset: bool = True, frame=None) -> PodSlot:
        """Lease a slot on the most-capacity pod.  Falls through to the
        next pod ONLY on failures where that pod provably did not grant
        a lease — connection refused, 409 (at capacity), 503 (resize
        did not land).  An ambiguous failure (timeout, mid-flight
        reset) re-raises: the pod may have granted the lease, and
        silently leasing elsewhere would leak it (the same contract as
        the non-idempotent retry policy).  The returned
        :class:`PodSlot`'s ``client`` names the pod it landed on.

        ``frame`` (an example frame) makes placement shape-aware:
        pods serving a different static resolution are skipped —
        the fleet can mix per-resolution pods and still place each
        client correctly.  Raises ``RuntimeError`` when reachable pods
        exist but none serves the frame's shape."""
        last_err: Optional[Exception] = None
        order = self._capacity_order(frame)
        if not order:
            raise RuntimeError(
                "fleet: no pod serves frames of signature "
                f"{frame_sig_json(frame)} (each pod serves ONE static "
                "shape; add a pod for this resolution)")
        for pod in order:
            try:
                return pod.acquire(maxsize=maxsize,
                                   when_empty=when_empty, reset=reset)
            except VaudioHTTPError as e:
                if e.status not in (409, 503):
                    raise
                last_err = e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                if not isinstance(getattr(e, "reason", e),
                                  ConnectionRefusedError):
                    raise
                last_err = e
        raise last_err if last_err is not None else RuntimeError(
            "fleet: no pods")

    def lease(self, maxsize: int = 8, when_empty: str = "hold",
              reset: bool = True, shrink: bool = False, frame=None):
        """Context-managed :meth:`acquire` (release on exit), like
        :meth:`PodClient.lease` but fleet-placed (and shape-aware with
        ``frame``)."""
        return _LeaseContext(
            lambda: self.acquire(maxsize=maxsize, when_empty=when_empty,
                                 reset=reset, frame=frame), shrink)
