"""The port's live HTTP server (vaudio_torch.runtime.server.LiveServer and
Auralizer.serve) on the CPU: the cases of tests/test_server.py against the
port, its helpers held to the JAX package's on the same inputs, and the
serving path end to end: frames pushed over HTTP (POST /frames, .npy RGB
bodies and raw I420 bodies) into a PushSource stream, per frame and in
chunks of 8, whose PCM equals the port's offline run bit for bit and the
JAX package's within 2e-5."""

import io
import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

import vaudio.runtime.chunked as jax_chunked
import vaudio.runtime.server as jax_server
import vaudio.runtime.step as jax_step
from torch_frames import rgb_to_yuv420, structured_frames, yuv420_bytes
from vaudio.api import Auralizer as JaxAuralizer
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.io import hsb_frames
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import PushSource, RawVideoSource
from vaudio_torch.io.push import push_frames
from vaudio_torch.runtime import chunked, server, step
from vaudio_torch.runtime.ringbuffer import NativeRingBuffer

TIMEOUT = 60.0
PCM_ATOL = 2e-5          # the JAX package's chunked band (test_chunked.py:20)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(url, obj, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post_bytes(url, body, timeout=30):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _http_error(call):
    with pytest.raises(urllib.error.HTTPError) as e:
        call()
    return e.value.code, e.value.read()


def wait_for(cond, what, timeout=TIMEOUT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def served_aur():
    """A port Auralizer with a running LiveServer (no stream started)."""
    aur = Auralizer(config=AuralizerConfig(mip_level=2), debug=True,
                    device="cpu")
    srv = aur.serve(port=0)
    try:
        yield aur, srv
    finally:
        srv.stop()
        aur.stop()


# ---------------------------------------------------------------------------
# tests/test_server.py, against the port
# ---------------------------------------------------------------------------

class TestEndpoints:
    def test_control_panel_page(self, served_aur):
        _aur, srv = served_aur
        status, ctype, body = _get(srv.url)
        assert status == 200 and ctype == "text/html"
        text = body.decode()
        for name in ("attack", "release", "spectrum_mixing", "hp_cutoff",
                     "lp_cutoff", "stereo_width"):
            assert name in text
        assert "/audio.wav" in text and "/metrics" in text

    def test_params_roundtrip(self, served_aur):
        aur, srv = served_aur
        status, _, body = _get(srv.url + "params")
        assert status == 200
        p = json.loads(body)
        assert p["attack"] == aur.params.attack
        assert p["pan_angles"] is None
        status, resp = _post(srv.url + "params",
                             {"attack": 0.25, "stereo_width": 0.5})
        assert status == 200 and resp["applied"] == 2
        assert aur.params.attack == 0.25
        assert aur.params.stereo_width == 0.5
        assert resp["params"]["attack"] == 0.25

    def test_params_pan_angles(self, served_aur):
        aur, srv = served_aur
        n = aur.config.num_cells
        _status, resp = _post(srv.url + "params", {"pan_angles": [0.3] * n})
        assert resp["applied"] == 1
        assert isinstance(aur.params.pan_angles, np.ndarray)
        _post(srv.url + "params", {"pan_angles": None})
        assert aur.params.pan_angles is None

    def test_params_unknown_key_warns(self, served_aur):
        _aur, srv = served_aur
        _status, resp = _post(srv.url + "params", {"bogus": 1.0})
        assert resp["applied"] == 0
        assert any("bogus" in w for w in resp["warnings"])

    def test_params_bad_json_is_400(self, served_aur):
        _aur, srv = served_aur
        req = urllib.request.Request(srv.url + "params", data=b"not json",
                                     method="POST")
        code, _ = _http_error(lambda: urllib.request.urlopen(req,
                                                             timeout=30))
        assert code == 400

    def test_metrics(self, served_aur):
        _aur, srv = served_aur
        status, _, body = _get(srv.url + "metrics")
        assert status == 200
        m = json.loads(body)
        assert "frames_processed" in m and "buffer_fill" in m

    def test_debug_png_404_before_any_frame(self, served_aur):
        _aur, srv = served_aur
        for name in ("hue_matrix", "input"):
            code, _ = _http_error(lambda: urllib.request.urlopen(
                f"{srv.url}debug/{name}.png", timeout=30))
            assert code == 404, name

    def test_debug_png_500_on_malformed_last_frame(self, served_aur):
        aur, srv = served_aur
        aur._stream.last_frame = np.zeros((4, 4, 4), np.uint8)
        try:
            code, body = _http_error(lambda: urllib.request.urlopen(
                srv.url + "debug/input.png", timeout=30))
            assert code == 500 and b"render" in body
        finally:
            aur._stream.last_frame = None

    def test_unknown_path_404(self, served_aur):
        _aur, srv = served_aur
        code, _ = _http_error(lambda: urllib.request.urlopen(
            srv.url + "nope", timeout=30))
        assert code == 404


class TestOpsEndpoints:
    def test_metrics_prom(self, served_aur):
        _aur, srv = served_aur
        status, ctype, body = _get(srv.url + "metrics.prom")
        assert status == 200 and ctype == "text/plain"
        text = body.decode()
        assert "# TYPE vaudio_frames_processed gauge" in text
        assert "\nvaudio_frames_processed 0" in text
        assert "vaudio_buffer_fill" in text

    def test_state_roundtrip_over_http(self, served_aur):
        aur, srv = served_aur
        status, ctype, body = _get(srv.url + "state.npz")
        assert status == 200 and ctype == "application/octet-stream"
        data = np.load(io.BytesIO(body))
        assert set(data.files) == {"hues", "phases", "prev_spectrum",
                                   "ola_tail", "running_max", "carry_type"}
        assert str(data["carry_type"]) == "StepCarry"
        assert data["hues"].shape == (aur.config.num_cells,)
        hues = data["hues"].copy()
        hues[:] = 123
        buf = io.BytesIO()
        np.savez(buf, hues=hues,
                 **{f: data[f] for f in data.files if f != "hues"})
        status, resp = _post_bytes(srv.url + "state.npz", buf.getvalue())
        assert resp["restored"] is True
        assert np.all(aur._stream.snapshot_carry().hues == 123)

    def test_state_restore_rejects_garbage(self, served_aur):
        _aur, srv = served_aur
        code, _ = _http_error(lambda: _post_bytes(srv.url + "state.npz",
                                                  b"not an npz"))
        assert code == 400


def png_pixels(body):
    (w, h) = struct.unpack(">II", body[16:24])
    idat, pos = b"", 8
    while pos < len(body):
        (ln,) = struct.unpack(">I", body[pos:pos + 4])
        if body[pos + 4:pos + 8] == b"IDAT":
            idat += body[pos + 8:pos + 8 + ln]
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, -1)[:, 1:].reshape(h, w, 3)


class TestLiveStreamSurface:
    def test_views_and_params_during_stream(self):
        """After a stream: the debug PNGs render from its state, the input
        preview shows the last frame (hue 0.33: green), a POST changes the
        params the step reads."""
        cfg = AuralizerConfig(mip_level=2)
        aur = Auralizer(config=cfg, params=LiveParams(spectrum_mixing=0.0),
                        debug=True, device="cpu")
        srv = aur.serve(port=0)
        frames = np.asarray(hsb_frames(0.33, 1.0, 1.0, 96, 96, 12))
        try:
            aur.run_until_exhausted(list(frames), timeout=TIMEOUT)
            for name in ("hue_matrix", "spectrum", "waveform", "input"):
                status, ctype, body = _get(
                    f"{srv.url}debug/{name}.png?t=1")
                assert status == 200 and ctype == "image/png"
                assert body.startswith(b"\x89PNG"), name
            _, _, body = _get(srv.url + "debug/input.png")
            px = png_pixels(body)
            assert px.shape == (96, 96, 3)
            mean = px.reshape(-1, 3).mean(0)
            assert mean[1] > mean[0] and mean[1] > mean[2]
            _status, resp = _post(srv.url + "params", {"release": 2.5})
            assert resp["applied"] == 1 and aur.params.release == 2.5
            _, _, body = _get(srv.url + "metrics")
            assert json.loads(body)["frames_processed"] == 12
        finally:
            srv.stop()
            aur.stop()

    def test_audio_wav_streams_pcm(self):
        """/audio.wav: a WAV header and the ring's int16 PCM."""
        cfg = AuralizerConfig(mip_level=2)
        aur = Auralizer(config=cfg, debug=True, device="cpu")
        srv = aur.serve(port=0)
        frames = np.asarray(hsb_frames(0.6, 1.0, 1.0, 96, 96, 10))
        try:
            aur.run_until_exhausted(list(frames), timeout=TIMEOUT)
            with urllib.request.urlopen(srv.url + "audio.wav",
                                        timeout=30) as r:
                assert r.headers.get_content_type() == "audio/wav"
                head = r.read(44)
                assert head[:4] == b"RIFF" and head[8:12] == b"WAVE"
                pcm = np.frombuffer(r.read(4 * cfg.hop_size), "<i2")
            assert pcm.size > 0 and np.abs(pcm).max() > 50
        finally:
            srv.stop()
            aur.stop()


class TestServeAFifoStream:
    def test_stream_from_a_fifo_is_served(self, tmp_path):
        """The counterpart of the JAX CLI's ``stream --serve`` case: a
        stream reading raw rgb24 frames from a FIFO through the native
        reader, with the panel answering while it runs."""
        h = w = 64
        frames = structured_frames(40, 12, h, w, mip=2)
        fifo = str(tmp_path / "frames.fifo")
        os.mkfifo(fifo)
        cfg = AuralizerConfig(mip_level=2, ring_buffer_frames=16)
        aur = Auralizer(source=RawVideoSource(fifo, w, h, native=True),
                        config=cfg, device="cpu")
        srv = aur.serve(port=0)
        release = threading.Event()

        def feed():
            with open(fifo, "wb") as f:
                f.write(frames[:6].tobytes())
                f.flush()
                release.wait(TIMEOUT)
                f.write(frames[6:].tobytes())

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            aur.start()
            wait_for(lambda: aur.metrics["frames_processed"] >= 6,
                     "the first frames")
            status, _, body = _get(srv.url + "metrics")
            assert status == 200 and aur.is_running
            assert json.loads(body)["frames_processed"] == 6
            release.set()
            wait_for(lambda: not aur.is_running, "the FIFO's end")
            aur.raise_if_failed()
            assert aur.metrics["frames_processed"] == 12
        finally:
            release.set()
            srv.stop()
            aur.stop()
        feeder.join(timeout=TIMEOUT)
        assert not feeder.is_alive()


# ---------------------------------------------------------------------------
# The helpers, held to the JAX package's
# ---------------------------------------------------------------------------

def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz(**planes):
    buf = io.BytesIO()
    np.savez(buf, **planes)
    return buf.getvalue()


_RNG = np.random.default_rng(3)
_RGB = _RNG.integers(0, 256, (6, 8, 3), dtype=np.uint8)
_YUV = {"y": _RNG.integers(0, 256, (6, 8), dtype=np.uint8),
        "u": _RNG.integers(0, 256, (3, 4), dtype=np.uint8),
        "v": _RNG.integers(0, 256, (3, 4), dtype=np.uint8)}
BODIES = {
    "npy_u8": (_npy(_RGB), {}),
    "npy_f32": (_npy(_RGB.astype(np.float32) / 255), {}),
    "npz_yuv": (_npz(**_YUV), {}),
    "raw_rgb24": (_RGB.tobytes(), {"w": "8", "h": "6"}),
    "raw_i420": (yuv420_bytes({k: v[None] for k, v in _YUV.items()}, 0),
                 {"w": "8", "h": "6", "fmt": "i420"}),
    "raw_nv12": (yuv420_bytes({k: v[None] for k, v in _YUV.items()}, 0,
                              "nv12"), {"w": "8", "h": "6", "fmt": "nv12"}),
    "raw_no_dims": (b"\x00" * 144, {}),
    "raw_rgb24_short": (b"\x00" * 100, {"w": "8", "h": "6"}),
    "raw_i420_short": (b"\x00" * 70, {"w": "8", "h": "6", "fmt": "i420"}),
    "raw_bad_fmt": (b"\x00" * 72, {"w": "8", "h": "6", "fmt": "yuyv"}),
    "npy_truncated": (_npy(_RGB)[:100], {}),
    "npz_truncated": (_npz(**_YUV)[:60], {}),
}


def _decoded(fn, body, query):
    try:
        out = fn(body, query)
    except ValueError as e:
        return ("error", str(e))
    if isinstance(out, dict):
        return {k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
                for k, v in out.items()}
    return (out.dtype.str, out.tolist())


@pytest.mark.parametrize("case", list(BODIES))
def test_decode_frame_body_equals_jax(case):
    body, query = BODIES[case]
    got = _decoded(server.decode_frame_body, body, query)
    assert got == _decoded(jax_server.decode_frame_body, body, query)
    failed = isinstance(got, tuple) and got[0] == "error"
    assert failed == case.endswith(("_short", "_dims", "_fmt", "_truncated"))


FRAMES = {
    "rgb_u8": np.zeros((64, 64, 3), np.uint8),
    "rgb_f32": np.zeros((64, 48, 3), np.float32),
    "rgba": np.zeros((64, 64, 4), np.uint8),
    "gray": np.zeros((64, 64), np.uint8),
    "strings": np.full((64, 64, 3), "a"),
    "too_small": np.zeros((12, 64, 3), np.uint8),
    "yuv": {"y": np.zeros((64, 64), np.uint8),
            "u": np.zeros((32, 32), np.uint8),
            "v": np.zeros((32, 32), np.uint8)},
    "yuv_odd": {"y": np.zeros((65, 63), np.uint8),
                "u": np.zeros((33, 32), np.uint8),
                "v": np.zeros((33, 32), np.uint8)},
    "yuv_bad_chroma": {"y": np.zeros((64, 64), np.uint8),
                       "u": np.zeros((16, 32), np.uint8),
                       "v": np.zeros((32, 32), np.uint8)},
    "yuv_missing": {"y": np.zeros((64, 64), np.uint8),
                    "u": np.zeros((32, 32), np.uint8)},
    "yuv_3d": {"y": np.zeros((64, 64, 1), np.uint8),
               "u": np.zeros((32, 32), np.uint8),
               "v": np.zeros((32, 32), np.uint8)},
    "yuv_text": {"y": np.full((64, 64), "a"),
                 "u": np.zeros((32, 32), np.uint8),
                 "v": np.zeros((32, 32), np.uint8)},
}


@pytest.mark.parametrize("mip", [None, 0, 2, 5])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_structure_error_equals_jax(frame, mip):
    """The ingest door's checks give the JAX package's message (or None),
    without and with a config (YUV needs mip_level >= 1; the mip must
    cover the cell grid)."""
    cfg = jcfg = None
    if mip is not None:
        cfg, jcfg = AuralizerConfig(mip_level=mip), JaxConfig(mip_level=mip)
    got = server.frame_structure_error(FRAMES[frame], cfg)
    assert got == jax_server.frame_structure_error(FRAMES[frame], jcfg)


METRICS = {
    "flat": {"frames_processed": 3, "latency_p50_ms": 1.25,
             "warmed_up": True, "hardware_latency_ms": 10.666,
             "name": "skipped", "none": None},
    "slots": {"n_streams": 2, "slots": [
        {"buffer_fill": 3, "dropped_frames": 0},
        {"buffer_fill": 1, "push_fill": 4, "name": "x"}],
        "dotted.key-name": 1},
    "empty": {},
}


@pytest.mark.parametrize("case", list(METRICS))
def test_prometheus_text_equals_jax(case):
    assert server.prometheus_text(METRICS[case]) == \
        jax_server.prometheus_text(METRICS[case])


def test_check_auth_and_wav_header():
    """A token gates every endpoint (header or ?token=); the live WAV
    header is the JAX package's."""
    aur = Auralizer(config=AuralizerConfig(mip_level=2), device="cpu")
    srv = aur.serve(port=0, token="s3cret")
    try:
        code, _ = _http_error(lambda: _get(srv.url + "metrics"))
        assert code == 401
        assert _get(srv.url + "metrics?token=s3cret")[0] == 200
        req = urllib.request.Request(
            srv.url + "params", headers={"Authorization": "Bearer s3cret"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        code, _ = _http_error(lambda: _get(srv.url + "metrics?token=%C3%A9"))
        assert code == 401
    finally:
        srv.stop()
    for rate, ch in ((48000.0, 2), (44100.0, 1)):
        assert server._wav_stream_header(rate, ch) == \
            jax_server._wav_stream_header(rate, ch)


# ---------------------------------------------------------------------------
# The serving path end to end
# ---------------------------------------------------------------------------

# 17 frames: however many frames the producer takes before its first
# dispatch waits, at least 8 are queued behind it (see below).
H, W, T = 32, 64, 17
LIVE = dict(channels=2, mip_level=2, use_pallas=True, use_pallas_vision=True,
            ring_buffer_frames=2 * T)


def post_i420(url, planes, t, timeout=30):
    """POST frame ``t`` of planar YUV as a raw I420 body."""
    status, resp = _post_bytes(
        f"{url}frames?w={W}&h={H}&fmt=i420", yuv420_bytes(planes, t),
        timeout)
    assert status == 200
    return resp


def dispatch_pattern(log):
    return [json.loads(line)["frames"] for line in open(log)]


def offline_by_pattern(clip, pattern, cfg, run_frame, run_chunk):
    """The offline run that the stream's dispatches make: chunks through
    ``run_chunk`` and single steps through ``run_frame``, the carry
    chained."""
    outs, carry, start = [], None, 0
    for n in pattern:
        part = ({k: v[start:start + n] for k, v in clip.items()}
                if isinstance(clip, dict) else clip[start:start + n])
        run = run_chunk if n > 1 else run_frame
        pcm, carry, _ = run(part, carry)
        outs.append(np.asarray(pcm).reshape(-1))
        start += n
    return np.concatenate(outs)


@pytest.mark.parametrize("chunk_frames", [1, 8])
@pytest.mark.parametrize("body", ["npy", "i420"])
def test_served_pcm_equals_run_offline(tmp_path, body, chunk_frames):
    """push_frames (.npy RGB bodies) or raw I420 bodies into
    Auralizer(source=PushSource(maxsize=T, when_empty="block")).serve():
    nothing dropped, the C++ ring, the PCM pulled equal bit for bit to the
    port's offline run with the stream's dispatches (run_offline per
    frame, run_offline_batched for a chunk of 8) and within 2e-5 of the
    JAX package's; a /state.npz of the port loads in the JAX package, and
    one of the JAX package restores in the port."""
    cfg, jcfg = AuralizerConfig(**LIVE), JaxConfig(**LIVE)
    rgb = structured_frames(41, T, H, W, mip=2)
    clip = rgb if body == "npy" else rgb_to_yuv420(rgb)
    log = str(tmp_path / "dispatches.jsonl")
    ps = PushSource(maxsize=T, when_empty="block")
    aur = Auralizer(source=ps, config=cfg, device="cpu",
                    chunk_frames=chunk_frames, metrics_log=log)
    srv = aur.serve(port=0)
    try:
        aur.start()
        # In chunks, the first dispatch waits on the carry lock (as behind
        # a concurrent snapshot) until every frame is queued, so that whole
        # chunks of 8 form.
        hold = (aur._stream._carry_lock if chunk_frames > 1
                else threading.Lock())
        with hold:
            if body == "npy":
                assert push_frames(srv.url, None, rgb, timeout=30) == T
            else:
                for t in range(T):
                    post_i420(srv.url, clip, t)
                _post(srv.url + "push", {"close": True})
        wait_for(lambda: not aur.is_running, "the stream's end")
        aur.raise_if_failed()
        m = aur.metrics
        assert m["frames_processed"] == T and m["dropped_frames"] == 0
        assert ps.dropped == 0 and ps.pushed == T
        assert isinstance(aur._stream.ring, NativeRingBuffer)
        got = aur.pull(T * cfg.hop_size * cfg.channels)
        pattern = dispatch_pattern(log)
        assert sum(pattern) == T
        assert (max(pattern) == 8) == (chunk_frames == 8)
        ref = offline_by_pattern(
            clip, pattern, cfg,
            lambda f, c: step.run_offline(f, cfg, carry=c, device="cpu"),
            lambda f, c: chunked.run_offline_batched(f, cfg, chunk=8,
                                                     carry=c, device="cpu"))
        assert np.abs(ref).max() > 0
        np.testing.assert_array_equal(got, ref)
        jref = offline_by_pattern(
            clip, pattern, jcfg,
            lambda f, c: jax_step.run_offline(f, jcfg, carry=c),
            lambda f, c: jax_chunked.run_offline_batched(f, jcfg, chunk=8,
                                                         carry=c))
        np.testing.assert_allclose(got, jref, atol=PCM_ATOL)

        # The checkpoint, both ways across the packages.
        _, _, saved = _get(srv.url + "state.npz")
        jaur = JaxAuralizer(config=jcfg, prefer_native=False)
        jaur.load_state(io.BytesIO(saved))
        mine = aur._stream.snapshot_carry()
        for f, v in jaur._stream.snapshot_carry()._asdict().items():
            np.testing.assert_array_equal(np.asarray(v), getattr(mine, f))
        other = jaur._stream.snapshot_carry()._replace(
            hues=np.full(16, 77, np.int32))
        buf = io.BytesIO()
        jax_checkpoint_save(buf, other)
        _post_bytes(srv.url + "state.npz", buf.getvalue())
        np.testing.assert_array_equal(aur._stream.snapshot_carry().hues, 77)
    finally:
        srv.stop()
        aur.stop()


def jax_checkpoint_save(buf, carry):
    from vaudio.runtime.checkpoint import save_state
    save_state(buf, carry)


def test_bad_frames_are_answered_at_the_door():
    """A malformed body or frame is answered with 400 and queued nowhere;
    a non-push stream answers 409; so does a failed one."""
    ps = PushSource(maxsize=4, when_empty="block")
    aur = Auralizer(source=ps, config=AuralizerConfig(mip_level=2),
                    device="cpu")
    srv = aur.serve(port=0)
    try:
        code, _ = _http_error(lambda: _post_bytes(srv.url + "frames",
                                                  _npy(_RGB)))
        assert code == 409                  # not started: no push source
        aur.start()
        for bad in (_npy(np.zeros((64, 64), np.uint8)),
                    _npy(np.zeros((8, 8, 3), np.uint8)), b"garbage",
                    _npz(**_YUV)):
            code, msg = _http_error(lambda: _post_bytes(srv.url + "frames",
                                                        bad))
            assert code == 400 and b"error" in msg
        assert ps.pushed == 0
        status, _, state = _get(srv.url + "push")
        assert json.loads(state)["pushed"] == 0
        code, _ = _http_error(lambda: _post(srv.url + "push", {"open": 1}))
        assert code == 400
        aur._stream._error = RuntimeError("injected wreck")
        code, msg = _http_error(lambda: _post_bytes(
            srv.url + "frames", _npy(np.zeros((64, 64, 3), np.uint8))))
        assert code == 409 and b"FAILED" in msg
    finally:
        aur._stream._error = None
        srv.stop()
        aur.stop()
    plain = Auralizer(config=AuralizerConfig(mip_level=2), device="cpu")
    srv = plain.serve(port=0)
    try:
        code, _ = _http_error(lambda: _post_bytes(
            srv.url + "frames", _npy(np.zeros((64, 64, 3), np.uint8))))
        assert code == 409
        assert json.loads(_get(srv.url + "push")[2]) == {"armed": False}
    finally:
        srv.stop()
