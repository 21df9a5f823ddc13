"""The port's pod panel (vaudio_torch.runtime.podserver.PodServer,
MultiStreamAuralizer.serve and its observe state) on the CPU: the cases of
tests/test_podserver.py against the port (the mesh pod's panel over
``devices=["cpu"] * 8``; the CLI cases wait for the port's CLI), then the
port held to the JAX package:

- the same clips through a JAX pod behind the JAX PodServer and the port's
  pod behind the port's PodServer: each slot's PCM within 2e-5 (the port's
  band against the JAX package's pod, tests/test_torch_multistream.py),
  final hues equal, ``/slots/<i>/params`` JSON equal, the ``/metrics`` key
  sets equal, the ``/metrics.prom`` series names and labels equal and the
  ``hue_matrix`` PNG bytes equal;
- a ``/state.npz`` downloaded from either package's pod restores into the
  other's through ``POST /state.npz`` bit for bit, and the next ticks of
  the two pods agree within 2e-5;
- the observe state (``last_pcm``, ``last_preview``) equal to the JAX
  pod's, and grown and trimmed by a resize as the JAX pod's is.

JAX pods here take ``prefer_native=False``: the port's tests never build
the JAX package's native library.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import vaudio.runtime.multistream as jax_multistream
from torch_frames import structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.io import hsb_frames
from vaudio.runtime.podserver import PodServer as JaxPodServer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.runtime import MultiStreamAuralizer, PodServer
from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine

TIMEOUT = 120.0
PCM_ATOL = 2e-5          # the port's pod against the JAX pod
HOP = 2048


def pod(cfg=None, n_streams=2, **kwargs):
    """The port's pod on the CPU (its engine on the CPU)."""
    cfg = cfg or AuralizerConfig()
    kwargs.setdefault("engine", AuralizerEngine(cfg, device="cpu"))
    return MultiStreamAuralizer(cfg, n_streams=n_streams, **kwargs)


def jax_pod(cfg=None, n_streams=2, **kwargs):
    return jax_multistream.MultiStreamAuralizer(
        cfg or JaxConfig(), n_streams=n_streams, prefer_native=False,
        **kwargs)


def wait_done(p, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while p.is_running and time.monotonic() < deadline:
        p.raise_if_failed()
        time.sleep(0.01)
    assert not p.is_running, "pod did not finish its finite sources"
    p.raise_if_failed()


def wait_for(cond, p, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        p.raise_if_failed()
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(url, obj, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post_bytes(url, body, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _png_size(body: bytes):
    import struct
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", body[16:24])
    return h, w


def _reds_greens(n=10):
    return (hsb_frames(0.0, 1.0, 1.0, width=64, height=64, num_frames=n),
            hsb_frames(0.33, 1.0, 1.0, width=64, height=64, num_frames=n))


@pytest.fixture(scope="module")
def served_pod():
    """A 2-slot port pod that has fully processed two short solid-color
    streams (different hues), with the PodServer attached BEFORE start
    so observe-state (waveform/input views) is populated."""
    # mip_level 1: 64x64 -> 32x32 mip = 64 px per 4x4 cell, past the
    # reference's count>20 hue gate so the per-slot hue views diverge.
    cfg = AuralizerConfig(mip_level=1)
    p = pod(cfg, n_streams=2, exit_when_exhausted=True)
    server = p.serve(port=0)
    reds, greens = _reds_greens()
    p.start([iter(reds), iter(greens)])
    wait_done(p)
    assert p.metrics.frames_processed == 2 * 10
    yield p, server
    server.stop()
    p.stop()


# ---------------------------------------------------------------------------
# tests/test_podserver.py, against the port
# ---------------------------------------------------------------------------

class TestEndpoints:
    def test_panel_page(self, served_pod):
        _pod, server = served_pod
        status, ctype, body = _get(server.url)
        assert status == 200 and ctype == "text/html"
        text = body.decode()
        assert "serving pod (2 slots)" in text
        assert "/audio.wav" in text and "/metrics" in text
        for name in ("attack", "stereo_width"):
            assert name in text

    def test_metrics(self, served_pod):
        p, server = served_pod
        status, _, body = _get(server.url + "metrics")
        assert status == 200
        m = json.loads(body)
        assert m["n_streams"] == 2
        assert m["frames_processed"] == p.metrics.frames_processed
        assert len(m["slots"]) == 2
        for slot in m["slots"]:
            assert {"active", "buffer_fill", "dropped_frames",
                    "underrun_samples"} <= set(slot)

    def test_per_slot_params_isolated(self, served_pod):
        p, server = served_pod
        status, _, body = _get(server.url + "slots/0/params")
        assert status == 200
        p0 = json.loads(body)
        assert p0["shared"] is False
        assert p0["attack"] == p.params[0].attack

        status, resp = _post(server.url + "slots/1/params",
                             {"stereo_width": 0.25, "attack": 0.5})
        assert status == 200 and resp["applied"] == 2
        assert p.params[1].stereo_width == 0.25
        assert p.params[1].attack == 0.5
        # Slot 0 untouched — per-slot control, not broadcast.
        assert p.params[0].stereo_width == 1.0
        assert p.params[0].attack == 1.0

    def test_unknown_param_warns(self, served_pod):
        _pod, server = served_pod
        status, resp = _post(server.url + "slots/0/params",
                             {"nonsense": 1.0})
        assert status == 200 and resp["applied"] == 0
        assert resp["warnings"]

    def test_bad_value_400(self, served_pod):
        _pod, server = served_pod
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.url + "slots/0/params", {"attack": "loud"})
        assert exc.value.code == 400

    def test_bad_slot_404(self, served_pod):
        _pod, server = served_pod
        for path in ("slots/7/params", "slots/x/params",
                     "slots/7/debug/spectrum.png", "nope"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(server.url + path)
            assert exc.value.code == 404


class TestSlotViews:
    def test_hue_matrix_differs_per_slot(self, served_pod):
        """Slot 0 saw red frames, slot 1 green — the per-slot hue-matrix
        views must render from each slot's own carry row."""
        _pod, server = served_pod
        bodies = []
        for s in (0, 1):
            status, ctype, body = _get(
                server.url + f"slots/{s}/debug/hue_matrix.png")
            assert status == 200 and ctype == "image/png"
            _png_size(body)
            bodies.append(body)
        assert bodies[0] != bodies[1]

    def test_spectrum_waveform_input_render(self, served_pod):
        _pod, server = served_pod
        for name in ("spectrum", "waveform", "input"):
            for s in (0, 1):
                status, ctype, body = _get(
                    server.url + f"slots/{s}/debug/{name}.png")
                assert status == 200 and ctype == "image/png", name
                _png_size(body)

    def test_observe_state_populated(self, served_pod):
        p, _server = served_pod
        assert p.observe is True
        for s in (0, 1):
            assert p.last_pcm[s] is not None
            assert p.last_preview[s] is not None
            assert p.last_preview[s].dtype == np.uint8


def _wait_not_busy(server, slot, timeout=15.0):
    """A closed listener's handler thread only notices on its next
    failed socket write, so the slot lock can outlive the client by a few
    quanta."""
    deadline = time.monotonic() + timeout
    while server.audio_busy(slot) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not server.audio_busy(slot)


class TestSlotAudio:
    def test_audio_wav_stream(self, served_pod):
        """/slots/<i>/audio.wav streams a live WAV: header + paced PCM
        (zero-fill after the pod stopped — the real-time contract)."""
        _pod, server = served_pod
        req = urllib.request.urlopen(server.url + "slots/0/audio.wav",
                                     timeout=30)
        try:
            head = req.read(44)
            assert head[:4] == b"RIFF" and head[8:12] == b"WAVE"
            body = req.read(256)      # a few paced quanta
            assert len(body) == 256
        finally:
            req.close()

    def test_audio_busy_flag(self, served_pod):
        _pod, server = served_pod
        _wait_not_busy(server, 0)
        req = urllib.request.urlopen(server.url + "slots/0/audio.wav",
                                     timeout=30)
        try:
            req.read(44)
            assert server.audio_busy(0) is True
            assert server.audio_busy(1) is False
            # Second listener on the same slot is refused.
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(server.url + "slots/0/audio.wav", timeout=10)
            assert exc.value.code == 409
        finally:
            req.close()
        _wait_not_busy(server, 0)


class TestReviewRegressions:
    def test_one_slot_pan_angles_post_is_refused(self, served_pod):
        """Setting pan_angles on ONE slot of a per-slot-params pod is
        refused (409) before the producer could see mixed slots; the
        pod-level broadcast sets and clears it on every slot."""
        p, server = served_pod
        n = p.cfg.num_cells
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url + "slots/0/params",
                  {"pan_angles": [0.5] * n})
        assert e.value.code == 409
        assert b"ALL slots" in e.value.read()
        assert p.params[0].pan_angles is None    # nothing applied

        status, resp = _post(server.url + "params",
                             {"pan_angles": [0.5] * n})
        assert status == 200 and resp["slots_updated"] == 2
        assert all(q.pan_angles is not None for q in p.params)
        status, _resp = _post(server.url + "slots/1/params",
                              {"pan_angles": [0.7] * n})
        assert status == 200
        assert float(np.asarray(p.params[1].pan_angles)[0]) == \
            pytest.approx(0.7)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url + "slots/1/params", {"pan_angles": None})
        assert e.value.code == 409
        status, resp = _post(server.url + "params", {"pan_angles": None})
        assert status == 200                       # restore fixture state
        assert all(q.pan_angles is None for q in p.params)

    def test_pan_broadcast_on_running_pod_survives(self):
        """A pan_angles update arriving mid-run through the broadcast
        leaves the pod alive (params_lock atomicity with the producer's
        stacking)."""
        cfg = AuralizerConfig(mip_level=1)
        p = pod(cfg, n_streams=2)
        server = p.serve(port=0)
        frames = hsb_frames(0.5, 1.0, 1.0, width=64, height=64,
                            num_frames=40)
        try:
            p.start([iter(frames), iter(frames.copy())])
            wait_for(lambda: p.metrics.frames_processed >= 8, p)
            status, resp = _post(
                server.url + "params",
                {"pan_angles": [0.4] * cfg.num_cells})
            assert status == 200 and resp["slots_updated"] == 2
            wait_done(p)
            assert p.metrics.frames_processed == 80
        finally:
            server.stop()
            p.stop()

    def test_broadcast_rejects_bad_value_without_diverging(self,
                                                           served_pod):
        p, server = served_pod
        before = [q.attack for q in p.params]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url + "params", {"attack": "loud"})
        assert e.value.code == 400
        assert [q.attack for q in p.params] == before

    def test_stop_on_never_started_server_returns(self):
        """stop() must not call shutdown() on a never-started server."""
        p = pod(AuralizerConfig(mip_level=1), n_streams=1)
        server = PodServer(p)            # constructed, never started
        done = []
        t = threading.Thread(
            target=lambda: (server.stop(), done.append(True)))
        t.start()
        t.join(timeout=10)
        assert done, "stop() deadlocked on a never-started server"

    def test_stop_disables_observe(self):
        p = pod(AuralizerConfig(mip_level=1), n_streams=1)
        server = p.serve(port=0)
        assert p.observe is True
        server.stop()
        assert p.observe is False

    def test_drain_exclusive(self, served_pod):
        """drain_exclusive runs fn under the slot audio lock and returns
        None while a listener holds the slot."""
        _pod, server = served_pod
        _wait_not_busy(server, 0)
        assert server.drain_exclusive(0, lambda: "ran") == "ran"
        req = urllib.request.urlopen(server.url + "slots/0/audio.wav",
                                     timeout=30)
        try:
            req.read(44)
            assert server.drain_exclusive(0, lambda: "ran") is None
        finally:
            req.close()
        _wait_not_busy(server, 0)

    def test_prometheus_groups_are_contiguous(self, served_pod):
        """All samples of one metric form a single group (text
        exposition format rule)."""
        _pod, server = served_pod
        _, _, body = _get(server.url + "metrics.prom")
        names = [line.split("{")[0].split(" ")[0]
                 for line in body.decode().splitlines()
                 if line and not line.startswith("#")]
        seen, last = set(), None
        for name in names:
            if name != last:
                assert name not in seen, f"{name} samples interleaved"
                seen.add(name)
                last = name


class TestPodOpsEndpoints:
    def test_metrics_prom_labels_slots(self, served_pod):
        _pod, server = served_pod
        status, ctype, body = _get(server.url + "metrics.prom")
        assert status == 200 and ctype == "text/plain"
        text = body.decode()
        assert "# TYPE vaudio_frames_processed gauge" in text
        assert 'vaudio_slot_buffer_fill{slot="0"}' in text
        assert 'vaudio_slot_dropped_frames{slot="1"}' in text

    def test_pod_state_roundtrip_over_http(self, served_pod):
        p, server = served_pod
        status, ctype, body = _get(server.url + "state.npz")
        assert status == 200 and ctype == "application/octet-stream"
        data = np.load(io.BytesIO(body))
        assert data["hues"].shape == (2, p.cfg.num_cells)

        hues = data["hues"].copy()
        hues[1, :] = 77
        buf = io.BytesIO()
        np.savez(buf, hues=hues,
                 **{f: data[f] for f in data.files if f != "hues"})
        status, resp = _post_bytes(server.url + "state.npz",
                                   buf.getvalue())
        assert status == 200 and resp["restored"] is True
        restored = np.asarray(p.snapshot_carry().hues)
        assert np.all(restored[1] == 77)
        assert np.all(restored[0] == data["hues"][0])
        # Put the fixture's carry back.
        _post_bytes(server.url + "state.npz", body)

    def test_pod_state_restore_rejects_wrong_pod_size(self, served_pod):
        """A single-stream (or wrong-N) checkpoint is refused: load_state
        shape-validates against the pod size."""
        from vaudio_torch.runtime.checkpoint import save_state
        from vaudio_torch.runtime.step import init_carry
        p, server = served_pod
        buf = io.BytesIO()
        save_state(buf, init_carry(p.cfg, "cpu"))    # unbatched carry
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_bytes(server.url + "state.npz", buf.getvalue())
        assert e.value.code == 400


class TestElasticResize:
    def test_resize_over_http(self):
        """POST /resize grows a LIVE pod; the panel, metrics, per-slot
        params and audio endpoints all see the new slots; a shrink drops
        them again, and the observe lists follow."""
        p = pod(n_streams=1, exit_when_exhausted=False)
        server = p.serve(port=0)
        try:
            clip = np.asarray(hsb_frames(0.6, 1.0, 1.0, width=64,
                                         height=64, num_frames=3))
            p.start([iter(clip)])
            wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)

            status, resp = _post(server.url + "resize", {"n_streams": 3})
            assert status == 200 and resp["n_streams"] == 3
            assert p.n_streams == 3
            assert len(p.last_pcm) == len(p.last_preview) == 3
            assert len(p._preview_t) == 3

            _, _, page = _get(server.url)
            assert "serving pod (3 slots)" in page.decode()
            _, _, body = _get(server.url + "metrics")
            m = json.loads(body)
            assert m["n_streams"] == 3 and len(m["slots"]) == 3

            status, resp = _post(server.url + "slots/2/params",
                                 {"attack": 0.5})
            assert status == 200 and resp["applied"] == 1
            assert p.params[2].attack == 0.5
            assert p.params[0].attack == 1.0
            assert server.audio_busy(2) is False

            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(server.url + "resize", {"n": 3})
            assert exc.value.code == 400

            status, resp = _post(server.url + "resize", {"n_streams": 2})
            assert status == 200 and resp["n_streams"] == 2
            assert len(p.last_pcm) == len(p.last_preview) == 2
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(server.url + "slots/2/params")
            assert exc.value.code == 404
        finally:
            server.stop()
            p.stop()


class TestSlotLeasingHTTP:
    def test_acquire_push_release_over_http(self):
        """POST /slots/acquire leases (growing the pod), the leased slot
        accepts frames, and /slots/<i>/release with shrink returns the
        capacity; push_frames' slot='acquire' mode drives it."""
        from vaudio_torch.io.push import push_frames
        p = pod(n_streams=1, max_streams=2, exit_when_exhausted=False)
        server = p.serve(port=0)
        try:
            clip = np.asarray(hsb_frames(0.1, 1.0, 1.0, width=64,
                                         height=64, num_frames=2))
            p.start([iter(clip)])      # slot 0 exhausts -> free
            wait_for(lambda: not any(p._active), p)

            status, resp = _post(server.url + "slots/acquire", {})
            assert status == 200 and resp["slot"] == 0
            assert resp["armed"] is True and p.n_streams == 1

            sent = push_frames(server.url, "acquire", iter(clip),
                               when_empty="dark", close=False)
            assert sent == 2 and p.n_streams == 2
            wait_for(lambda: p.stream_metrics(1)["buffer_fill"] >= 2, p)

            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(server.url + "slots/acquire", {})
            assert exc.value.code == 409

            status, resp = _post(server.url + "slots/1/release",
                                 {"shrink": True})
            assert status == 200 and resp["n_streams"] == 1
            assert p.n_streams == 1
        finally:
            server.stop()
            p.stop()


class TestMeshPodPanel:
    def test_panel_on_mesh_sharded_pod(self):
        """The panel works on a mesh pod: per-slot views render from the
        SHARDED batched carry (the snapshot joins the shards), and the
        broadcast respects the shared-params contract (applied once,
        reported shared)."""
        from vaudio.io import solid_color_frames
        from vaudio_torch.parallel import make_stream_mesh

        cfg = AuralizerConfig()
        mesh = make_stream_mesh(8, 1, devices=["cpu"] * 8)  # stream-DP
        shared = LiveParams()
        p = pod(cfg, n_streams=8, params=shared, mesh=mesh)
        server = p.serve(port=0)
        clips = [solid_color_frames(
            [0.2 + 0.1 * i, 0.9 - 0.1 * i, 0.3], 64, 64, 4)
            for i in range(8)]
        try:
            p.start([iter(np.asarray(c)) for c in clips])
            wait_done(p)
            for s in (0, 7):
                for view in ("hue_matrix", "spectrum"):
                    status, ctype, body = _get(
                        server.url + f"slots/{s}/debug/{view}.png")
                    assert status == 200 and ctype == "image/png"
                    _png_size(body)
            status, resp = _post(server.url + "params", {"release": 0.25})
            assert status == 200 and resp["shared"] is True
            assert resp["slots_updated"] == 1      # one shared object
            assert shared.release == 0.25
            status, _, body = _get(server.url + "metrics.prom")
            assert 'vaudio_slot_buffer_fill{slot="7"}' in body.decode()
            status, _, body = _get(server.url + "state.npz")
            assert np.load(io.BytesIO(body))["hues"].shape == (8, 16)
        finally:
            server.stop()
            p.stop()


class TestSharedParams:
    def test_shared_flag_and_broadcast(self):
        """One shared LiveParams: POST to any slot updates every slot and
        the response says shared=true."""
        cfg = AuralizerConfig(mip_level=2)
        shared = LiveParams()
        p = pod(cfg, n_streams=2, params=shared)
        server = p.serve(port=0)
        try:
            status, resp = _post(server.url + "slots/0/params",
                                 {"release": 0.125})
            assert status == 200 and resp["shared"] is True
            assert p.params[1].release == 0.125
            status, resp = _post(server.url + "params", {"release": 0.25})
            assert resp["shared"] is True and resp["slots_updated"] == 1
            assert shared.release == 0.25
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# The port's panel held to the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_panels():
    """The same two hsb clips through a JAX pod behind the JAX PodServer
    and the port's pod behind the port's PodServer (both served before
    start, so the observe state fills)."""
    reds, greens = _reds_greens()
    ref = jax_pod(JaxConfig(mip_level=1))
    jsrv = ref.serve(port=0)
    got = pod(AuralizerConfig(mip_level=1))
    psrv = got.serve(port=0)
    for p in (ref, got):
        p.start([iter(reds), iter(greens)])
        wait_done(p)
    yield ref, jsrv, got, psrv
    for s in (jsrv, psrv):
        s.stop()
    ref.stop()
    got.stop()


def _prom_series(text):
    return {line.split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


class TestAgainstTheJaxPanel:
    def test_observe_state_equals_jax(self, both_panels):
        ref, _jsrv, got, _psrv = both_panels
        assert got.observe is ref.observe is True
        assert got.preview_interval == ref.preview_interval
        for s in range(2):
            np.testing.assert_array_equal(got.last_preview[s],
                                          ref.last_preview[s])
            assert got.last_pcm[s].shape == ref.last_pcm[s].shape
            np.testing.assert_allclose(got.last_pcm[s], ref.last_pcm[s],
                                       rtol=0, atol=PCM_ATOL)

    def test_pcm_and_hues_equal_jax(self, both_panels):
        ref, _jsrv, got, _psrv = both_panels
        np.testing.assert_array_equal(got.snapshot_carry().hues,
                                      np.asarray(ref.snapshot_carry().hues))
        for s in range(2):
            n = 10 * HOP * ref.cfg.channels
            want = ref.pull(s, n)
            assert np.abs(want).max() > 1e-3
            np.testing.assert_allclose(got.pull(s, n), want, rtol=0,
                                       atol=PCM_ATOL)

    @pytest.mark.parametrize("path", ["slots/0/params", "slots/1/params",
                                      "metrics", "metrics.prom",
                                      "slots/0/push",
                                      "slots/1/debug/hue_matrix.png"])
    def test_endpoint_equals_jax(self, both_panels, path):
        _ref, jsrv, _got, psrv = both_panels
        js, jctype, jbody = _get(jsrv.url + path)
        ps, pctype, pbody = _get(psrv.url + path)
        assert (ps, pctype) == (js, jctype)
        if path == "metrics":
            jm, pm = json.loads(jbody), json.loads(pbody)
            assert set(pm) == set(jm)
            assert [set(s) for s in pm["slots"]] == \
                [set(s) for s in jm["slots"]]
            assert pm["frame_sig"] == jm["frame_sig"]
        elif path == "metrics.prom":
            assert _prom_series(pbody.decode()) == \
                _prom_series(jbody.decode())
        else:
            assert pbody == jbody            # params JSON, PNG bytes

    @pytest.mark.parametrize("path,body", [
        ("slots/0/params", {"pan_angles": [0.5] * 16}),
        ("slots/0/params", {"attack": "loud"}),
        ("params", {"attack": "loud"}),
        ("resize", {"n": 3}),
        ("slots/9/params", {"attack": 0.5}),
        ("slots/0/push", {"when_empty": "block"}),
        ("slots/0/push", {"close": True}),
        ("slots/0/frames", None),
        ("state.npz", None),
        ("nope", {}),
    ])
    def test_refusals_equal_jax(self, both_panels, path, body):
        """The same bad requests get the same status codes and messages
        from both packages' panels, and change nothing."""
        _ref, jsrv, got, psrv = both_panels
        data = b"junk" if body is None else json.dumps(body).encode()
        answers = []
        for srv in (jsrv, psrv):
            req = urllib.request.Request(srv.url + path, data=data,
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            answers.append((e.value.code,
                            json.loads(e.value.read())["error"]))
        if path == "state.npz":              # the loaders' own words
            answers = [(c, m.split(":")[0]) for c, m in answers]
        assert answers[1] == answers[0]
        assert all(q.pan_angles is None and q.attack == 1.0
                   for q in got.params)

    def test_audio_wav_header_equals_jax(self, both_panels):
        _ref, jsrv, _got, psrv = both_panels
        heads = []
        for srv in (jsrv, psrv):
            r = urllib.request.urlopen(srv.url + "slots/1/audio.wav",
                                       timeout=30)
            try:
                heads.append(r.read(44))
            finally:
                r.close()
        assert heads[0] == heads[1]


def test_checkpoints_cross_the_packages_over_http():
    """Each package's pod runs the same 6 frames; each one's /state.npz
    is POSTed into the other's panel (restored bit for bit), and the next
    4 frames of the two pods agree within 2e-5."""
    clips = [structured_frames(60 + s, 10, 64, 64) for s in range(2)]
    ref = jax_pod(JaxConfig())
    got = pod(AuralizerConfig())
    jsrv, psrv = ref.serve(port=0), got.serve(port=0)
    try:
        for p in (ref, got):
            p.start([iter(c[:6]) for c in clips])
            wait_done(p)
            p.stop()
        _, _, jblob = _get(jsrv.url + "state.npz")
        _, _, pblob = _get(psrv.url + "state.npz")
        assert _post_bytes(psrv.url + "state.npz", jblob)[1] == \
            {"restored": True}
        assert _post_bytes(jsrv.url + "state.npz", pblob)[1] == \
            {"restored": True}
        for p, blob in ((got, jblob), (ref, pblob)):
            data = np.load(io.BytesIO(blob))
            for f, x in zip(type(p.snapshot_carry())._fields,
                            p.snapshot_carry()):
                np.testing.assert_array_equal(np.asarray(x), data[f])
        for p in (ref, got):
            p.start([iter(c[6:]) for c in clips])
            wait_done(p)
        for s in range(2):
            want = ref.pull(s, 4 * HOP)
            assert np.abs(want).max() > 1e-3
            np.testing.assert_allclose(got.pull(s, 4 * HOP), want, rtol=0,
                                       atol=PCM_ATOL)
    finally:
        jsrv.stop()
        psrv.stop()
        ref.stop()
        got.stop()


@pytest.mark.parametrize("family", ["auralizer", "orthomodes"])
def test_state_npz_restores_from_a_file_object(family):
    """POST /state.npz hands the pod a BytesIO: both families' loaders
    take a file object; OrthoModes answers 409 before its first tick (a
    frame-sized carry) and has no hue_matrix view (404), as the JAX pod."""
    if family == "auralizer":
        p = pod(n_streams=2)
        clip_of = lambda s: structured_frames(s, 3, 64, 64)  # noqa: E731
    else:
        eng = OrthoModesEngine(AuralizerConfig(), device="cpu")
        p = MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                 chunk_frames=2)
        clip_of = lambda s: structured_frames(s, 3, 64, 128)  # noqa: E731
    server = p.serve(port=0)
    try:
        if family == "orthomodes":
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + "state.npz")
            assert e.value.code == 409
        p.start([iter(clip_of(s)) for s in range(2)])
        wait_done(p)
        status, _, blob = _get(server.url + "state.npz")
        before = p.snapshot_carry()
        p.load_state(io.BytesIO(blob))
        assert _post_bytes(server.url + "state.npz", blob)[1] == \
            {"restored": True}
        for a, b in zip(before, p.snapshot_carry()):
            np.testing.assert_array_equal(a, b)
        code = 200 if family == "auralizer" else 404
        try:
            status = _get(server.url + "slots/0/debug/hue_matrix.png")[0]
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == code
    finally:
        server.stop()
        p.stop()


def test_served_chunked_pod_equals_the_jax_pod():
    """A served pod in chunks of 3 (the partial chunk padded): its PCM
    and hues against the JAX pod served the same way, and the waveform
    view's row shape (hop, channels) on a stereo config."""
    clips = [structured_frames(70 + s, 5, 64, 64) for s in range(2)]
    kw = dict(channels=2, use_pallas=True, use_pallas_vision=True)
    ref = jax_pod(JaxConfig(**kw), chunk_frames=3)
    got = pod(AuralizerConfig(**kw), chunk_frames=3)
    servers = [ref.serve(port=0), got.serve(port=0)]
    try:
        for p in (ref, got):
            p.start([iter(c) for c in clips])
            wait_done(p)
        assert got.last_pcm[0].shape == ref.last_pcm[0].shape == (HOP, 2)
        np.testing.assert_array_equal(got.snapshot_carry().hues,
                                      np.asarray(ref.snapshot_carry().hues))
        for s in range(2):
            want = ref.pull(s, 5 * HOP * 2)
            np.testing.assert_allclose(got.pull(s, 5 * HOP * 2), want,
                                       rtol=0, atol=PCM_ATOL)
        assert got.metrics.dispatches == ref.metrics.dispatches == 2
    finally:
        for s in servers:
            s.stop()
        ref.stop()
        got.stop()


def test_serve_signature_equals_jax():
    import inspect
    for a, b in ((MultiStreamAuralizer.serve,
                  jax_multistream.MultiStreamAuralizer.serve),
                 (PodServer.__init__, JaxPodServer.__init__)):
        sa, sb = inspect.signature(a), inspect.signature(b)
        assert [(q.name, q.default) for q in sa.parameters.values()] == \
            [(q.name, q.default) for q in sb.parameters.values()]
    public = {n for n in dir(JaxPodServer) if not n.startswith("__")}
    assert public <= set(dir(PodServer))
