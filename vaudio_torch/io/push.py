"""Push-model frame sources — the PyTorch port's copy of
:mod:`vaudio.io.push`: frames arrive from another thread (an HTTP handler,
an RPC server, a capture callback) instead of being pulled from a file
descriptor.

This is the network-serving counterpart of the reference's capture
delegate: AVFoundation *pushes* frames into
``captureOutput(_:didOutput:from:)`` (VisionEngine.swift:77-101) and the
engine consumes them at its own cadence, dropping what it cannot keep up
with (``alwaysDiscardsLateVideoFrames``, CameraModel.swift:24).
:class:`PushSource` reproduces that contract host-side: a bounded
thread-safe queue where *newest frames win* — when the queue is full the
oldest queued frame is dropped, never the incoming one.

A serving pod (:mod:`vaudio_torch.runtime.multistream`)
consumes sources in lockstep, one ``next()`` per slot per tick, so a push
slot must never block the batch. The ``when_empty`` policy controls what
an empty queue yields:

* ``"hold"``  — repeat the last delivered frame (a camera held still:
  hues/gradients persist, audio sustains). Before the first frame
  arrives, yields ``None`` (an idle tick — the pod keeps the slot dark
  but alive).
* ``"dark"``  — yield ``None`` every empty tick (silence between
  frames).
* ``"block"`` — wait for the next push (single-stream use, where the
  producer thread serves exactly one source and blocking is the natural
  pacing).

``close()`` ends the stream: the iterator drains what is queued, then
raises ``StopIteration`` (the slot exhausts / goes dark like any other
ended source).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, Optional

__all__ = ["PushSource", "encode_frame", "push_frames"]


def encode_frame(frame) -> tuple:
    """Serialize one frame for the HTTP ingest door (``POST .../frames``,
    decoded server-side by
    :func:`vaudio_torch.runtime.server.decode_frame_body`): RGB arrays go as
    self-describing ``.npy`` bodies, planar-YUV dicts (members y/u/v) as
    ``.npz``.  Returns ``(body_bytes, content_type)``."""
    import io

    import numpy as np
    buf = io.BytesIO()
    if isinstance(frame, dict):
        np.savez(buf, **{k: np.ascontiguousarray(v)
                         for k, v in frame.items()})
    else:
        np.save(buf, np.ascontiguousarray(frame))
    return buf.getvalue(), "application/octet-stream"


class PushSource:
    """Thread-safe push-model frame source (see module docstring).

    Args:
      maxsize: queue capacity in frames. When full, ``push`` drops the
        OLDEST queued frame (real-time semantics — the engine should
        always see the freshest input; CameraModel.swift:24).
      when_empty: ``"hold"`` | ``"dark"`` | ``"block"`` — what the
        iterator yields when the queue is empty (module docstring).
    """

    def __init__(self, maxsize: int = 8, when_empty: str = "hold"):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        if when_empty not in ("hold", "dark", "block"):
            raise ValueError(
                f"when_empty must be 'hold', 'dark' or 'block', "
                f"not {when_empty!r}")
        self.maxsize = int(maxsize)
        self.when_empty = when_empty
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._last = None          # last frame handed out (hold policy)
        #: Frames discarded because the queue was full when a newer one
        #: arrived (the alwaysDiscardsLateVideoFrames counter).
        self.dropped = 0
        #: Total frames accepted by :meth:`push`.
        self.pushed = 0
        #: Monotonic time of the last accepted :meth:`push` (arm time
        #: before the first frame, so a fresh source starts "live").
        #: Client-liveness signal: the pod's dead-client reaper
        #: (``MultiStreamAuralizer.lease_timeout``) measures idleness
        #: from here — frame ARRIVAL, never consumption.
        self.last_push = time.monotonic()
        #: True when this source backs a LEASE (``acquire_slot``) rather
        #: than an operator-armed ingest door; the reaper distinguishes
        #: them (a never-fed door stays open, a never-fed lease expires).
        self.leased = False

    # -- producer side -------------------------------------------------------

    def push(self, frame) -> None:
        """Enqueue one frame (any object the pipeline accepts: an RGB
        array, a planar-YUV dict). Never blocks: a full queue drops its
        oldest entry. Raises ``ValueError`` after :meth:`close`."""
        with self._cond:
            if self._closed:
                raise ValueError("push on a closed PushSource")
            if len(self._q) >= self.maxsize:
                self._q.popleft()
                self.dropped += 1
            self._q.append(frame)
            self.pushed += 1
            self.last_push = time.monotonic()
            self._cond.notify()

    def close(self) -> None:
        """End the stream: queued frames still drain, then the iterator
        stops. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def fill(self) -> int:
        """Frames currently queued."""
        with self._cond:
            return len(self._q)

    def frames(self) -> Iterator[Optional["object"]]:
        """The consumer iterator (one consumer at a time). Yields frames,
        or ``None`` on empty ticks under the ``hold``/``dark`` policies
        (``hold`` yields the previous frame once one exists)."""
        _IDLE = object()
        while True:
            # Pop under the lock, yield OUTSIDE it: a generator suspended
            # at a yield inside the `with` would hold the condition while
            # the consumer processes the frame, deadlocking pushers.
            with self._cond:
                if self.when_empty == "block":
                    while not self._q and not self._closed:
                        self._cond.wait()
                if self._q:
                    frame = self._q.popleft()
                    self._last = frame
                elif self._closed:
                    return
                else:
                    frame = _IDLE        # empty, open, non-blocking
            if frame is _IDLE:
                yield self._last if self.when_empty == "hold" else None
            else:
                yield frame

    __iter__ = frames

    def state(self) -> dict:
        """JSON-ready queue state (the pod panel's ``GET
        /slots/<i>/push`` body)."""
        with self._cond:
            return {"armed": True, "closed": self._closed,
                    "fill": len(self._q), "maxsize": self.maxsize,
                    "pushed": self.pushed, "dropped": self.dropped,
                    "when_empty": self.when_empty}


def push_frames(base_url: str, slot: Optional[int], frames,
                fps: Optional[float] = None, arm: bool = True,
                when_empty: str = "hold", maxsize: int = 8,
                reset: bool = False, close: bool = True,
                timeout: float = 30.0, retries: int = 0,
                retry_wait: float = 0.5,
                token: Optional[str] = None) -> int:
    """HTTP client for a serving pod's network-ingest door: arm
    ``slot`` on the pod at ``base_url`` (``POST /slots/<slot>/push``),
    stream ``frames`` to it one ``POST /slots/<slot>/frames`` at a time
    (self-describing ``.npy`` bodies; planar-YUV dict frames go as
    ``.npz``), optionally paced at ``fps``, then close the push stream.
    Returns the number of frames sent.  Server-rejected frames (4xx)
    raise ``RuntimeError`` with the pod's error message — e.g. a frame
    violating the pod's static shape contract.  ``retries`` re-sends
    after TRANSIENT failures (connection refused/reset, 503), waiting
    ``retry_wait`` seconds between attempts — a pod restarting behind
    the same address does not kill a long-running camera push.

    ``slot=None`` targets a SINGLE-STREAM panel instead
    (``Auralizer.serve`` on a :class:`PushSource` stream: root ``POST
    /frames`` / ``/push`` endpoints, pre-armed at launch so ``arm`` is
    ignored).

    ``slot="acquire"`` asks the pod to LEASE a slot first
    (``POST /slots/acquire`` — reuses a free slot or elastically grows
    the pod up to its ``max_streams``); the lease ends with the final
    close.  The fleet-client mode: no slot bookkeeping on the caller.

    The server sides are :class:`vaudio_torch.runtime.server.LiveServer`
    and a serving pod's panel
    (:class:`vaudio_torch.runtime.podserver.PodServer`)."""
    import json
    import time
    import urllib.error
    import urllib.request

    base = base_url.rstrip("/")
    token = token or None         # "" = no token (server semantics)

    def post(path: str, data: bytes, ctype: str,
             idempotent: bool = True) -> dict:
        # `retries` covers TRANSIENT failures only: connection
        # refused/reset (a pod restarting behind the same address) and
        # 503 answers (a resize momentarily wedging the producer).
        # Real rejections (other 4xx/5xx) raise immediately; a retried
        # duplicate frame is just the newest-wins queue's normal
        # behavior.  Non-idempotent posts (acquire: a lease is granted)
        # only re-send after REFUSED or 503 — the two failures where
        # the server provably did not apply the request.
        headers = {"Content-Type": ctype}
        if token is not None:     # serve(token=...) panels: bearer auth
            headers["Authorization"] = f"Bearer {token}"
        for attempt in range(retries + 1):
            req = urllib.request.Request(
                f"{base}{path}", data=data, method="POST",
                headers=dict(headers))
            try:
                with urllib.request.urlopen(req,
                                            timeout=timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")
                if e.code != 503 or attempt == retries:
                    raise RuntimeError(
                        f"pod rejected POST {path} ({e.code}): "
                        f"{detail}") from None
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                refused = isinstance(getattr(e, "reason", e),
                                     ConnectionRefusedError)
                if attempt == retries or not (idempotent or refused):
                    raise
            time.sleep(retry_wait)

    if slot == "acquire":
        # No "reset" key unless explicitly requested: the pod's lease
        # default is a COLD DSP carry (acquire_slot reset_carry=True) —
        # push_frames' own reset default (False, meaningful for a fixed
        # --slot re-arm) must not override it; a leased slot's index is
        # pod-chosen, so warm "same camera back" reuse cannot apply.
        body = {"when_empty": when_empty, "maxsize": maxsize}
        if reset:
            body["reset"] = True
        resp = post("/slots/acquire", json.dumps(body).encode(),
                    "application/json", idempotent=False)
        slot = int(resp["slot"])
        print(f"push: leased slot {slot} "
              f"(pod now {resp.get('n_streams')} slots)",
              file=__import__("sys").stderr)
        arm = False                    # acquire already armed it
    prefix = "" if slot is None else f"/slots/{slot}"
    if arm and slot is not None:
        post(f"{prefix}/push",
             json.dumps({"when_empty": when_empty, "maxsize": maxsize,
                         "reset": reset}).encode(), "application/json")
    period = None if not fps else 1.0 / float(fps)
    next_t = time.monotonic()
    sent = 0
    ok = False
    try:
        for frame in frames:
            if period is not None:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t = max(next_t + period, time.monotonic())
            body, ctype = encode_frame(frame)
            post(f"{prefix}/frames", body, ctype)
            sent += 1
        ok = True
    finally:
        if close:
            try:
                post(f"{prefix}/push", b'{"close": true}',
                     "application/json")
            except Exception:
                # When the send loop itself failed, the close POST to
                # the same dead/unreachable host must not mask WHICH
                # frame POST failed; on a successful send, a failed
                # close is a real error the caller needs (the server
                # would never learn the stream ended).
                if ok:
                    raise
    return sent
