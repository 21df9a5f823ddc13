"""The rest of the port's io (vaudio_torch.io.sources and .sinks) on the
CPU, against the JAX package's on the same inputs: the synthetic HSB frames
and the BGRA conversion bit for bit, WAV files crossing between the two
packages, the speaker sink through a fake ``$VAUDIO_PLAYER``, the encoded
video sources (decoded through cv2 where it imports, and their
missing-backend errors without cv2 and ffmpeg)."""

import sys

import numpy as np
import pytest

import vaudio.io as jax_io
import vaudio_torch.io as port_io
from vaudio_torch.io import sinks


@pytest.mark.parametrize("h,s,b", [(0.0, 1.0, 1.0), (0.33, 1.0, 1.0),
                                   (0.58, 0.4, 0.7), (0.999, 0.9, 0.2),
                                   (1.25, 0.0, 0.5), (0.5, 1.0, 0.0)])
def test_hsb_frames_equal_jax(h, s, b):
    np.testing.assert_array_equal(port_io.hsb_to_rgb(h, s, b),
                                  jax_io.hsb_to_rgb(h, s, b))
    got = port_io.hsb_frames(h, s, b, width=48, height=32, num_frames=3)
    want = jax_io.hsb_frames(h, s, b, width=48, height=32, num_frames=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_solid_color_and_bgra_equal_jax():
    rgb = [0.8, 0.2, 0.1]
    np.testing.assert_array_equal(
        port_io.solid_color_frames(rgb, 40, 24, 2),
        jax_io.solid_color_frames(rgb, 40, 24, 2))
    bgra = np.random.default_rng(0).integers(0, 256, (2, 24, 40, 4),
                                             dtype=np.uint8)
    got = port_io.bgra_to_rgb(bgra)
    assert got.dtype == np.float32 and got.shape == (2, 24, 40, 3)
    np.testing.assert_array_equal(got, jax_io.bgra_to_rgb(bgra))


def test_exports_match_the_jax_io():
    """Every name of vaudio.io is exported by the port's io."""
    assert set(jax_io.__all__) <= set(port_io.__all__)
    assert port_io.VIDEO_FILE_EXTENSIONS == jax_io.VIDEO_FILE_EXTENSIONS


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_crosses_the_packages(tmp_path, channels):
    """A WAV written by either package reads back the same through the
    other's read_wav, and the two writers write the same bytes."""
    rng = np.random.default_rng(channels)
    pcm = rng.uniform(-1.2, 1.2, (1000, channels)).astype(np.float32)
    if channels == 1:
        pcm = pcm[:, 0]
    port_path, jax_path = tmp_path / "p.wav", tmp_path / "j.wav"
    port_io.write_wav(str(port_path), pcm, 48000.0, channels=channels)
    jax_io.write_wav(str(jax_path), pcm, 48000.0, channels=channels)
    assert port_path.read_bytes() == jax_path.read_bytes()
    got, sr = port_io.read_wav(str(jax_path))
    want, jsr = jax_io.read_wav(str(port_path))
    assert sr == jsr == 48000.0
    np.testing.assert_array_equal(got, want)
    assert got.shape == pcm.shape
    np.testing.assert_allclose(got, np.clip(pcm, -1, 1), atol=1.0 / 32767)


def test_subprocess_player_through_a_fake_player(tmp_path, monkeypatch):
    """``$VAUDIO_PLAYER`` is invoked as ``<player> <rate> <channels>`` and
    fed f32le PCM on stdin; the JAX package builds the same command."""
    dump = tmp_path / "played.f32"
    fake = tmp_path / "fakeplay"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"open({str(dump)!r}, 'wb').write("
                    "sys.stdin.buffer.read())\n"
                    f"open({str(dump)!r} + '.args', 'w').write("
                    "' '.join(sys.argv[1:]))\n")
    fake.chmod(0o755)
    monkeypatch.setenv("VAUDIO_PLAYER", str(fake))
    assert sinks._player_command(48000, 2) == \
        jax_io.sinks._player_command(48000, 2) == [str(fake), "48000", "2"]
    assert port_io.SubprocessPlayer.available()
    pcm = np.random.default_rng(1).uniform(-1, 1, (300, 2)).astype(
        np.float32)
    with port_io.SubprocessPlayer(48000.0, 2) as player:
        player.write(pcm[:100])
        player.write(pcm[100:].reshape(-1))
        assert player.samples_written == 600
    assert player.close() == 0
    np.testing.assert_array_equal(
        np.frombuffer(dump.read_bytes(), "<f4"), pcm.reshape(-1))
    assert (tmp_path / "played.f32.args").read_text() == "48000 2"


def test_player_search_without_a_player(monkeypatch):
    monkeypatch.delenv("VAUDIO_PLAYER", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    assert sinks._player_command(44100, 1) is None
    assert not port_io.SubprocessPlayer.available()
    with pytest.raises(RuntimeError, match="no audio player found"):
        port_io.SubprocessPlayer(44100.0)


@pytest.fixture
def no_decoder(monkeypatch):
    """No cv2 module and no ffmpeg binary, as on the card's machine."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setenv("PATH", "/nonexistent")


def test_missing_decode_backend_errors_match_jax(tmp_path, no_decoder):
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"not a video")
    errors = []
    for mod in (port_io, jax_io):
        with pytest.raises(RuntimeError) as e:
            mod.VideoFileSource(str(path))
        errors.append(str(e.value))
        with pytest.raises(RuntimeError, match="opencv-python"):
            mod.VideoFileSource(str(path), backend="cv2")
        with pytest.raises(RuntimeError, match="opencv-python"):
            mod.Cv2CameraSource(0)
    assert errors[0] == errors[1]
    assert "neither the cv2 module nor an ffmpeg binary" in errors[0]
    with pytest.raises(FileNotFoundError):
        port_io.VideoFileSource(str(tmp_path / "missing.mp4"))
    with pytest.raises(ValueError, match="unknown backend"):
        port_io.VideoFileSource(str(path), backend="gstreamer")


def _write_mp4(path, frames):
    cv2 = pytest.importorskip("cv2")
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (w, h))
    if not writer.isOpened():
        pytest.skip("cv2 VideoWriter cannot encode mp4 in this build")
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()


def test_video_file_and_camera_sources_decode_as_jax(tmp_path):
    """Through cv2 (where it imports): the port's VideoFileSource and
    Cv2CameraSource decode an mp4 to the JAX classes' frames bit for bit,
    in RGB order, with the camera's live continuation and max_frames."""
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    frames = np.stack([np.full((48, 64, 3), c, np.uint8)
                       for c in colors * 2])
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, frames)
    src = port_io.VideoFileSource(path)
    assert src.backend == "cv2" and src.shape == (48, 64)
    assert src.num_frames == len(frames)
    got = src.tensor()
    np.testing.assert_array_equal(got, jax_io.VideoFileSource(path).tensor())
    assert got.dtype == np.uint8 and got.shape == frames.shape
    np.testing.assert_allclose(got.mean(axis=(1, 2)),
                               frames.mean(axis=(1, 2)), atol=30)
    as_float = port_io.VideoFileSource(path, as_float=True).tensor()
    np.testing.assert_array_equal(as_float, got.astype(np.float32) / 255.0)
    with port_io.Cv2CameraSource(path, max_frames=5) as cam:
        assert cam.shape == (48, 64)
        first = [next(cam.frames()) for _ in range(2)]
        rest = list(cam.frames())
    assert len(first) + len(rest) == 5
    np.testing.assert_array_equal(np.stack(first + rest), got[:5])
    with pytest.raises(RuntimeError, match="could not open"):
        port_io.Cv2CameraSource(str(tmp_path / "nonexistent.mp4"))

