"""The port's serving clients (vaudio_torch.client) on the CPU: the cases of
tests/test_client.py against the port's servers (StreamClient against the
port's LiveServer, PodClient, PodSlot and FleetClient against the port's
PodServer; the CLI, doctor and mesh cases wait for the port's CLI and
mesh), then the port held to the JAX package:

- ``frame_sig_json`` equal to the JAX function on RGB (u8 and float),
  grey and I420 frames, and to the port pod's ``frame_sig`` in
  ``/metrics``;
- crossed clients: one script of calls (acquire, push, params, broadcast,
  metrics, state, resize, release, and the refusals among them) gets the
  same status codes and the same JSON keys from the port's PodClient
  against the JAX PodServer as from the JAX PodClient against the port's
  PodServer, and as from each package against itself.

JAX servers here take ``prefer_native=False``: the port's tests never build
the JAX package's native library.
"""

import socket
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import vaudio.client as jax_client
import vaudio.runtime.multistream as jax_multistream
import vaudio_torch.client as client_mod
from torch_frames import rgb_to_yuv420, structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.io import hsb_frames
from vaudio_torch.api import Auralizer
from vaudio_torch.client import (AudioStream, FleetClient, PodClient,
                                 StreamClient, VaudioHTTPError,
                                 frame_sig_json)
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.runtime import MultiStreamAuralizer
from vaudio_torch.runtime.engine import AuralizerEngine

TIMEOUT = 120.0


def pod(cfg=None, n_streams=1, **kwargs):
    """The port's pod on the CPU (its engine on the CPU)."""
    cfg = cfg or AuralizerConfig()
    kwargs.setdefault("engine", AuralizerEngine(cfg, device="cpu"))
    return MultiStreamAuralizer(cfg, n_streams=n_streams, **kwargs)


def wait_for(cond, p, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        p.raise_if_failed()
        assert time.monotonic() < deadline
        time.sleep(0.01)


def hsb(hue, size=64, n=1):
    return np.asarray(hsb_frames(hue, 1.0, 1.0, width=size, height=size,
                                 num_frames=n))


@pytest.fixture(scope="module")
def served_stream():
    """A finished single-stream run on the port with its LiveServer up."""
    aur = Auralizer(config=AuralizerConfig(mip_level=2), debug=True,
                    device="cpu")
    server = aur.serve(port=0)
    aur.run_until_exhausted(list(hsb(0.33, 96, 12)), timeout=300)
    yield aur, server, StreamClient(server.url)
    server.stop()
    aur.stop()


@pytest.fixture(scope="module")
def served_pod():
    """A 2-slot port pod that processed two short clips, PodServer up."""
    p = pod(AuralizerConfig(mip_level=1), n_streams=2,
            exit_when_exhausted=True)
    server = p.serve(port=0)
    p.start([iter(hsb(0.0, n=10)), iter(hsb(0.66, n=10))])
    wait_for(lambda: not p.is_running, p)
    p.raise_if_failed()
    yield p, server, PodClient(server.url)
    server.stop()
    p.stop()


# ---------------------------------------------------------------------------
# tests/test_client.py, against the port
# ---------------------------------------------------------------------------

class TestStreamClient:
    def test_params_roundtrip(self, served_stream):
        aur, _server, client = served_stream
        p = client.params()
        assert p["attack"] == aur.params.attack
        resp = client.set_params(attack=0.25, stereo_width=0.5)
        assert resp["applied"] == 2
        assert aur.params.attack == 0.25
        assert client.params()["stereo_width"] == 0.5

    def test_metrics_and_prom(self, served_stream):
        _aur, _server, client = served_stream
        assert client.metrics()["frames_processed"] == 12
        prom = client.metrics_prom()
        assert "vaudio_frames_processed 12" in prom

    def test_view_png(self, served_stream):
        _aur, _server, client = served_stream
        for name in ("hue_matrix", "spectrum", "waveform", "input"):
            assert client.view(name).startswith(b"\x89PNG"), name

    def test_record_audio(self, served_stream):
        aur, _server, client = served_stream
        rate = aur.config.sample_rate
        pcm = client.record(0.15)
        want = int(round(0.15 * rate))
        assert pcm.dtype == np.float32 and len(pcm) == want
        assert np.abs(pcm).max() > 1e-3      # a real synthesis run

    def test_audio_stream_header(self, served_stream):
        aur, _server, client = served_stream
        # The previous listener's lock frees on the server's next paced
        # write after the disconnect — retry briefly.
        deadline = time.monotonic() + 30
        while True:
            try:
                stream = client.audio(chunk_samples=256)
                break
            except VaudioHTTPError as e:
                assert e.status == 409 and time.monotonic() < deadline
                time.sleep(0.05)
        with stream:
            assert isinstance(stream, AudioStream)
            assert stream.sample_rate == int(aur.config.sample_rate)
            assert stream.channels == aur.config.channels
            chunk = next(iter(stream))
            assert chunk.shape == (256, aur.config.channels)

    def test_error_mapping(self, served_stream):
        _aur, _server, client = served_stream
        with pytest.raises(VaudioHTTPError) as exc:
            client.set_params(attack="junk")
        assert exc.value.status == 400
        assert "junk" in exc.value.message
        # A non-push stream refuses pushed frames with a clear 409.
        with pytest.raises(VaudioHTTPError) as exc:
            client.push(np.zeros((8, 8, 3), np.float32))
        assert exc.value.status == 409

    def test_state_roundtrip(self, served_stream):
        _aur, _server, client = served_stream
        blob = client.save_state()
        assert blob[:2] == b"PK"                 # a .npz (zip) payload
        assert client.load_state(blob) == {"restored": True}


class TestPodClient:
    def test_slots_and_metrics(self, served_pod):
        p, _server, client = served_pod
        assert client.n_streams == 2
        slots = client.slots()
        assert [s.index for s in slots] == [0, 1]
        m = slots[0].metrics()
        assert m["buffer_fill"] == p.stream_metrics(0)["buffer_fill"]
        assert "vaudio_slot_buffer_fill" in client.metrics_prom()

    def test_slot_params(self, served_pod):
        p, _server, client = served_pod
        slot = client.slot(1)
        resp = slot.set_params(stereo_width=0.25)
        assert resp["applied"] == 1 and resp["shared"] is False
        assert p.params[1].stereo_width == 0.25
        assert p.params[0].stereo_width != 0.25
        assert slot.params()["stereo_width"] == 0.25

    def test_broadcast_params(self, served_pod):
        p, _server, client = served_pod
        n = p.cfg.num_cells
        resp = client.broadcast_params(pan_angles=[0.3] * n)
        assert resp["slots_updated"] == 2
        assert all(q.pan_angles is not None for q in p.params)
        # One-slot pan_angles flip is the documented 409.
        with pytest.raises(VaudioHTTPError) as exc:
            client.slot(0).set_params(pan_angles=None)
        assert exc.value.status == 409
        client.broadcast_params(pan_angles=None)
        assert all(q.pan_angles is None for q in p.params)

    def test_slot_views_and_record(self, served_pod):
        p, _server, client = served_pod
        for name in ("hue_matrix", "spectrum", "waveform", "input"):
            assert client.slot(0).view(name).startswith(b"\x89PNG")
        pcm = client.slot(1).record(0.1)
        assert len(pcm) == int(round(0.1 * p.cfg.sample_rate))
        assert np.abs(pcm).max() > 1e-3

    def test_bad_slot_404(self, served_pod):
        _pod, _server, client = served_pod
        with pytest.raises(VaudioHTTPError) as exc:
            client.slot(7).params()
        assert exc.value.status == 404
        with pytest.raises(VaudioHTTPError) as exc:
            client.slot(7).metrics()
        assert exc.value.status == 404
        with pytest.raises(VaudioHTTPError):
            client.slot(-1).metrics()

    def test_state_roundtrip(self, served_pod):
        _pod, _server, client = served_pod
        blob = client.save_state()
        assert client.load_state(blob) == {"restored": True}


class TestPodLeasing:
    def test_lease_context_manager(self):
        """with pod.lease() leases, pushes, and releases on exit —
        including the elastic grow/shrink round trip."""
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False)
        server = p.serve(port=0)
        client = PodClient(server.url)
        clip = hsb(0.1, n=2)
        try:
            p.start([iter(clip[:1])])      # slot 0 exhausts -> free
            wait_for(lambda: not any(p._active), p)
            with client.lease(when_empty="dark") as slot:
                assert slot.index == 0       # reused the free slot
                assert slot.push_state()["armed"] is True
                for fr in clip:
                    slot.push(fr)
                wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 2,
                         p)
            wait_for(lambda: 0 in p.free_slots(), p)
            with client.lease(when_empty="dark") as a:
                with client.lease(when_empty="dark") as b:
                    assert {a.index, b.index} == {0, 1}
                    with pytest.raises(VaudioHTTPError) as exc:
                        client.acquire()
                    assert exc.value.status == 409
        finally:
            server.stop()
            p.stop()


def _answering_server(state, payload):
    """A local HTTP server answering 503 while ``state["fails"]`` > 0,
    then ``payload``; counts its hits."""
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _answer(self):
            state["hits"] += 1
            code, body = 200, payload
            if state["fails"] > 0:
                state["fails"] -= 1
                code, body = 503, b'{"error": "resize in flight"}'
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST = _answer
    return H


def _resetter():
    """A listening socket that accepts, reads and closes without an
    answer (the ambiguous failure class); returns (url, hits, stop)."""
    hits = []
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    port = lsock.getsockname()[1]
    stop = threading.Event()

    def loop():
        lsock.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            hits.append(1)
            try:
                conn.recv(4096)
            finally:
                conn.close()
        lsock.close()
    threading.Thread(target=loop, daemon=True).start()
    return f"http://127.0.0.1:{port}", hits, stop


class TestRetries:
    """Transient-failure resilience: retries on 503 and connection
    errors; real rejections (4xx) never retry."""

    def _flaky_server(self, fails_503=0, body=None):
        payload = body or b'{"n_streams": 1, "slots": []}'
        state = {"fails": fails_503, "hits": 0}
        srv = ThreadingHTTPServer(("127.0.0.1", 0),
                                  _answering_server(state, payload))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}", state

    def test_client_retries_503(self):
        srv, url, state = self._flaky_server(fails_503=2)
        try:
            with pytest.raises(VaudioHTTPError) as exc:
                PodClient(url).metrics()          # no retries: first 503
            assert exc.value.status == 503
            m = PodClient(url, retries=3, retry_wait=0.01).metrics()
            assert m["n_streams"] == 1
            assert state["hits"] == 3
        finally:
            srv.shutdown()

    def test_client_does_not_retry_4xx(self):
        p = pod()
        server = p.serve(port=0)
        try:
            client = PodClient(server.url, retries=5, retry_wait=0.01)
            t0 = time.monotonic()
            with pytest.raises(VaudioHTTPError) as exc:
                client.slot(0).set_params(attack="junk")
            assert exc.value.status == 400
            assert time.monotonic() - t0 < 1.0    # no retry pauses
        finally:
            server.stop()
            p.stop()

    def test_client_retries_connection_refused(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()                                 # nothing listens now
        url = f"http://127.0.0.1:{port}"
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            OSError)):
            PodClient(url).metrics()             # no retries: fails now
        # A server that comes up mid-retry-loop is reached.
        srv = [None]
        started = threading.Event()
        state = {"fails": 0, "hits": 0}

        def serve_late():
            time.sleep(0.4)
            try:
                sv = ThreadingHTTPServer(
                    ("127.0.0.1", port),
                    _answering_server(state, b'{"n_streams": 1}'))
            except OSError:
                return                            # port got reused
            srv[0] = sv
            started.set()
            sv.serve_forever()

        threading.Thread(target=serve_late, daemon=True).start()
        try:
            m = PodClient(url, retries=20, retry_wait=0.1).metrics()
            assert m["n_streams"] == 1 and started.is_set()
        finally:
            if srv[0] is not None:
                srv[0].shutdown()

    def test_acquire_does_not_retry_ambiguous_failures(self):
        """A mid-flight reset on /slots/acquire is NOT retried, while the
        same failure on an idempotent GET retries."""
        url, hits, stop = _resetter()
        try:
            client = PodClient(url, retries=3, retry_wait=0.01, timeout=5)
            n0 = len(hits)
            with pytest.raises(Exception):
                client.acquire()
            assert len(hits) - n0 == 1
            n0 = len(hits)
            with pytest.raises(Exception):
                client.metrics()                  # idempotent: retries
            assert len(hits) - n0 == 4            # 1 + 3 retries
        finally:
            stop.set()

    def test_push_frames_retry_503(self):
        from vaudio_torch.io.push import push_frames
        srv, url, state = self._flaky_server(
            fails_503=1, body=b'{"queued": true, "fill": 1}')
        try:
            sent = push_frames(url, 0, [np.zeros((8, 8, 3), np.float32)],
                               arm=False, close=False, retries=2,
                               retry_wait=0.01)
            assert sent == 1 and state["hits"] == 2
        finally:
            srv.shutdown()


class TestFleetClient:
    """Fleet placement: acquire lands on the most-capacity pod, falls
    through full/dead pods, raises when everything is at capacity."""

    def _pod(self, max_streams, cfg=None):
        p = pod(cfg, n_streams=1, max_streams=max_streams,
                exit_when_exhausted=False)
        server = p.serve(port=0)
        p.start([iter(())])
        return p, server

    def test_placement_and_fallthrough(self):
        pod_a, srv_a = self._pod(max_streams=1)
        pod_b, srv_b = self._pod(max_streams=2)
        try:
            a_slot = PodClient(srv_a.url).acquire(when_empty="dark")
            fleet = FleetClient(["http://127.0.0.1:1",   # nothing there
                                 srv_a.url, srv_b.url])
            with fleet.lease(when_empty="dark") as slot:
                assert slot.client.url == srv_b.url.rstrip("/")
                slot.push(hsb(0.2)[0])
                slot2 = fleet.acquire(when_empty="dark")
                assert slot2.client.url == srv_b.url.rstrip("/")
                assert pod_b.n_streams == 2
                with pytest.raises(Exception) as exc:
                    fleet.acquire()
                assert isinstance(exc.value, (VaudioHTTPError, OSError))
                slot2.release()
            a_slot.release()
            m = fleet.metrics()
            assert m[0] is None                 # the dead URL
            assert m[2]["n_streams"] == 2
        finally:
            srv_a.stop(); pod_a.stop()
            srv_b.stop(); pod_b.stop()

    def test_shape_aware_placement(self):
        """A mixed-resolution fleet routes each client to a pod of its
        frame's shape; a shape nobody serves raises."""
        cfg = AuralizerConfig(mip_level=1)

        def pod_with_shape(size):
            p = pod(cfg, n_streams=1, max_streams=2,
                    exit_when_exhausted=False)
            server = p.serve(port=0)
            p.start([iter(hsb(0.3, size, 2))])   # establishes the contract
            wait_for(lambda: not any(p._active), p)
            return p, server

        pod_s, srv_s = pod_with_shape(32)
        pod_l, srv_l = pod_with_shape(64)
        try:
            fleet = FleetClient([srv_s.url, srv_l.url])
            big, small = hsb(0.5, 64)[0], hsb(0.5, 32)[0]
            with fleet.lease(when_empty="dark", frame=big) as slot:
                assert slot.client.url == srv_l.url.rstrip("/")
                slot.push(big)
            with fleet.lease(when_empty="dark", frame=small) as slot:
                assert slot.client.url == srv_s.url.rstrip("/")
            with pytest.raises(RuntimeError, match="no pod serves"):
                fleet.acquire(frame=np.zeros((48, 48, 3), np.float32))
        finally:
            srv_s.stop(); pod_s.stop()
            srv_l.stop(); pod_l.stop()

    def test_ambiguous_acquire_failure_reraises(self):
        """A mid-flight reset on a pod's /slots/acquire re-raises out of
        the fleet instead of silently leasing elsewhere."""
        url, _hits, stop = _resetter()
        try:
            fleet = FleetClient([url], timeout=5)
            with pytest.raises((urllib.error.URLError, ConnectionError,
                                OSError)):
                fleet.acquire()
        finally:
            stop.set()

    def test_free_slots_metric(self):
        p = pod(n_streams=2, max_streams=4, exit_when_exhausted=False)
        server = p.serve(port=0)
        try:
            p.start([iter(()), iter(())])
            client = PodClient(server.url)
            wait_for(lambda: client.metrics()["free_slots"] >= 2, p)
            m = client.metrics()
            assert m["free_slots"] == 2 and m["max_streams"] == 4
            client.acquire(when_empty="dark")
            assert client.metrics()["free_slots"] == 1
        finally:
            server.stop()
            p.stop()


class TestAuthToken:
    """Bearer-token panels: with serve(token=...), every endpoint requires
    the token; the browser page embeds it; clients send it as a header."""

    def test_stream_panel_token(self):
        import urllib.request
        aur = Auralizer(config=AuralizerConfig(mip_level=2), debug=True,
                        device="cpu")
        server = aur.serve(port=0, token="s3cret")
        try:
            with pytest.raises(VaudioHTTPError) as exc:
                StreamClient(server.url).metrics()
            assert exc.value.status == 401
            client = StreamClient(server.url, token="s3cret")
            assert "frames_processed" in client.metrics()
            assert client.set_params(attack=0.3)["applied"] == 1
            with urllib.request.urlopen(
                    server.url + "?token=s3cret", timeout=30) as r:
                page = r.read().decode()
            assert "?token=s3cret" in page and "&token=s3cret" in page
            with pytest.raises(VaudioHTTPError) as exc:
                StreamClient(server.url, token="wrong").metrics()
            assert exc.value.status == 401
        finally:
            server.stop()
            aur.stop()

    def test_pod_panel_token(self):
        from vaudio_torch.io.push import push_frames
        p = pod(exit_when_exhausted=False)
        server = p.serve(port=0, token="podkey")
        try:
            p.start([iter(())])
            with pytest.raises(VaudioHTTPError) as exc:
                PodClient(server.url).metrics()
            assert exc.value.status == 401
            assert PodClient(server.url, token="podkey").n_streams == 1
            frame = hsb(0.1)[0]
            sent = push_frames(server.url, 0, [frame], when_empty="dark",
                               token="podkey")
            assert sent == 1
            with pytest.raises(RuntimeError, match="401"):
                push_frames(server.url, 0, [frame], when_empty="dark")
        finally:
            server.stop()
            p.stop()

    def test_non_ascii_token_answers_401(self):
        import urllib.request
        p = pod()
        server = p.serve(port=0, token="kéy")
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    server.url + "metrics?token=%C3%A9", timeout=30)
            assert exc.value.code == 401
            assert PodClient(server.url, token="kéy").n_streams == 1
        finally:
            server.stop()
            p.stop()

    def test_empty_token_disables_auth(self):
        p = pod()
        server = p.serve(port=0, token="")
        try:
            assert PodClient(server.url).n_streams == 1
        finally:
            server.stop()
            p.stop()


# ---------------------------------------------------------------------------
# The port's clients held to the JAX package's
# ---------------------------------------------------------------------------

def _frames_for_sig():
    rgb = structured_frames(5, 2, 32, 48)
    yuv = rgb_to_yuv420(rgb)
    return {
        "rgb_u8": rgb[0],
        "rgb_f32": rgb[0].astype(np.float32) / 255.0,
        "rgb_f64": rgb[0].astype(np.float64),
        "grey_u8": rgb[0, :, :, 0],
        "grey_f32": rgb[0, :, :, 0].astype(np.float32),
        "i420": {k: v[0] for k, v in yuv.items()},
        "i420_i16": {k: v[0].astype(np.int16) for k, v in yuv.items()},
    }


@pytest.mark.parametrize("kind", sorted(_frames_for_sig()))
def test_frame_sig_json_equals_jax(kind):
    frame = _frames_for_sig()[kind]
    assert frame_sig_json(frame) == jax_client.frame_sig_json(frame)


@pytest.mark.parametrize("kind", ["rgb_u8", "rgb_f32", "i420"])
def test_frame_sig_json_equals_the_pods_metrics(kind):
    """A pod fed a frame advertises that frame's frame_sig_json in
    /metrics (the fleet's shape-aware placement compares the two)."""
    frame = _frames_for_sig()[kind]
    p = pod(AuralizerConfig(mip_level=1), exit_when_exhausted=False)
    server = p.serve(port=0)
    try:
        p.start([iter([frame])])
        client = PodClient(server.url)
        wait_for(lambda: client.metrics()["frame_sig"] is not None, p)
        assert client.metrics()["frame_sig"] == frame_sig_json(frame)
    finally:
        server.stop()
        p.stop()


def test_public_names_equal_jax():
    import inspect
    assert client_mod.__all__ == jax_client.__all__
    for name in client_mod.__all__ + ["_PanelClient", "_LeaseContext"]:
        ours, theirs = getattr(client_mod, name), getattr(jax_client, name)
        if inspect.isclass(ours):
            members = {n for n in vars(theirs)
                       if not n.startswith("__") or n == "__init__"}
            assert members <= set(dir(ours)), name
            for m in members:
                if inspect.isfunction(vars(theirs)[m]):
                    assert inspect.signature(getattr(ours, m)) == \
                        inspect.signature(getattr(theirs, m)), (name, m)
        else:
            assert inspect.signature(ours) == inspect.signature(theirs)


def _script(mod, url):
    """One script of pod calls through client module ``mod`` against the
    panel at ``url``: [(call, status, sorted JSON keys or a summary)]."""
    c = mod.PodClient(url)
    out = []

    def call(name, fn):
        try:
            r = fn()
        except mod.VaudioHTTPError as e:
            out.append((name, e.status, None))
            return None
        if isinstance(r, dict):
            out.append((name, 200, sorted(r)))
        elif isinstance(r, bytes):
            out.append((name, 200, sorted(np.load(__import__("io")
                                                  .BytesIO(r)).files)))
        else:
            out.append((name, 200, type(r).__name__))
        return r

    frame = hsb(0.4)[0]
    a = c.acquire(when_empty="dark")
    b = c.acquire(when_empty="dark")
    out.append(("acquire", a.index, b.index, c.n_streams))
    call("push", lambda: a.push(frame))
    call("push_state", a.push_state)
    call("params", a.params)
    call("set_params", lambda: a.set_params(attack=0.5, nonsense=1))
    call("set_params_bad", lambda: a.set_params(attack="junk"))
    call("one_slot_pan", lambda: a.set_params(pan_angles=[0.3] * 16))
    call("broadcast", lambda: c.broadcast_params(pan_angles=[0.3] * 16))
    call("broadcast_clear", lambda: c.broadcast_params(pan_angles=None))
    call("broadcast_bad", lambda: c.broadcast_params(release="x"))
    m = call("metrics", c.metrics)
    out.append(("metric_slots", sorted(m["slots"][0])))
    blob = call("save_state", c.save_state)
    call("load_state", lambda: c.load_state(blob))
    call("load_state_bad", lambda: c.load_state(b"junk"))
    call("resize", lambda: c.resize(3))
    call("resize_over_cap", lambda: c.resize(9))
    call("slot_metrics", lambda: c.slot(2).metrics())
    call("view_missing", lambda: c.slot(2).view("waveform"))
    call("arm_block", lambda: c.slot(2).arm_push(when_empty="block"))
    call("arm", lambda: c.slot(2).arm_push(when_empty="dark"))
    call("close", lambda: c.slot(2).close_push())
    call("release", lambda: b.release(shrink=True))
    call("release_gone", lambda: c.slot(5).release())
    call("resize_back", lambda: c.resize(1))
    call("acquire_over_cap", lambda: (c.acquire(), c.acquire(),
                                      c.acquire(), c.acquire()))
    return out


def _jax_pod_panel():
    p = jax_multistream.MultiStreamAuralizer(
        JaxConfig(mip_level=1), n_streams=1, max_streams=3,
        exit_when_exhausted=False, prefer_native=False)
    return p, p.serve(port=0)


def _port_pod_panel():
    p = pod(AuralizerConfig(mip_level=1), n_streams=1, max_streams=3,
            exit_when_exhausted=False)
    return p, p.serve(port=0)


@pytest.mark.parametrize("client,server", [
    ("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")])
def test_crossed_clients_see_the_same_answers(client, server):
    """The same script of calls gets the same status codes and JSON keys
    whichever package's client talks to whichever package's pod panel;
    the reference is the JAX client against the JAX panel."""
    mods = {"port": client_mod, "jax": jax_client}
    panels = {"port": _port_pod_panel, "jax": _jax_pod_panel}
    answers = []
    for c, s in ((client, server), ("jax", "jax")):
        p, srv = panels[s]()
        try:
            p.start([iter(())])
            wait_for(lambda: 0 in p.free_slots(), p)
            answers.append(_script(mods[c], srv.url))
        finally:
            srv.stop()
            p.stop()
    assert answers[0] == answers[1]
    statuses = {a[0]: a[1] for a in answers[0] if len(a) == 3}
    assert statuses["one_slot_pan"] == 409
    assert statuses["set_params_bad"] == statuses["load_state_bad"] == 400
    assert statuses["acquire_over_cap"] == 409
