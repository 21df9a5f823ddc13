"""The port's live control channel and live debug surface
(vaudio_torch.runtime.control) on the CPU: control messages against the
JAX package's on the same inputs, the channel from a file, a FIFO and a
file object, and the live debug renderer on a running CPU stream."""

import dataclasses
import io
import os
import time

import numpy as np
import pytest

import vaudio.runtime.control as jax_control
import vaudio.utils.render as jax_render
from torch_frames import structured_frames
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.config import LiveParams as JaxLiveParams
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.runtime import control, step

TIMEOUT = 60.0


def wait_for(cond, what, timeout=TIMEOUT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def params_dict(p):
    d = dataclasses.asdict(p)
    if d["pan_angles"] is not None:
        d["pan_angles"] = np.asarray(d["pan_angles"]).tolist()
    return d


MESSAGES = {
    "scalars": {"attack": 0.2, "release": "2.5", "spectrum_mixing": 0,
                "stereo_width": 1.5, "hp_order": 2},
    "unknown_key": {"bogus": 1.0, "lp_cutoff": 8000.0},
    "pan_angles": {"pan_angles": [0.1 * k for k in range(16)]},
    "pan_angles_clear": {"pan_angles": None, "attack": 3.0},
    "pan_angles_wrong_length": {"pan_angles": [0.0] * 5},
    "pan_angles_not_finite": {"pan_angles": [np.nan] + [0.0] * 15},
    "pan_angles_2d": {"pan_angles": [[0.0] * 4] * 4},
    "non_finite_scalar": {"release": float("inf"), "attack": "nan"},
    "bad_value": {"attack": 0.3, "release": "fast"},
}


@pytest.mark.parametrize("num_cells", [16, None])
@pytest.mark.parametrize("msg", list(MESSAGES))
def test_apply_control_message_equals_jax(msg, num_cells):
    """The same params, count of applied fields and warnings as the JAX
    package's apply_control_message, or the same error."""
    outs = []
    for apply, make in ((control.apply_control_message, LiveParams),
                        (jax_control.apply_control_message, JaxLiveParams)):
        params = make(pan_angles=np.zeros(16, np.float32))
        warnings = []
        try:
            n = apply(params, dict(MESSAGES[msg]), warn=warnings.append,
                      num_cells=num_cells)
        except (TypeError, ValueError) as e:
            n = (type(e), str(e))
        outs.append((n, warnings, params_dict(params)))
    assert outs[0] == outs[1]
    assert control.CONTROLLABLE == jax_control.CONTROLLABLE


SCHEDULE = ('{"attack": 0.5}\n\nnot json\n[1, 2]\n'
            '{"release": 4.0, "typo": 1}\n{"stereo_width": 0.0}\n'
            '{"pan_angles": [0.5, 0.5]}\n')


@pytest.mark.parametrize("kind", ["file", "file_object"])
def test_control_channel_schedule_equals_jax(tmp_path, kind):
    """A scripted schedule read once to its end, from a path or a file
    object: the params, counters and warnings of the JAX channel."""
    path = tmp_path / "schedule.jsonl"
    path.write_text(SCHEDULE)
    outs = []
    for channel, make in ((control.ControlChannel, LiveParams),
                          (jax_control.ControlChannel, JaxLiveParams)):
        params, warnings, updates = make(), [], []
        src = str(path) if kind == "file" else io.StringIO(SCHEDULE)
        ch = channel(params, src, on_update=updates.append,
                     warn=warnings.append, num_cells=16).start()
        ch._thread.join(timeout=TIMEOUT)
        assert not ch._thread.is_alive()
        ch.stop()
        outs.append((ch.applied, ch.messages, warnings, updates,
                     params_dict(params)))
    assert outs[0] == outs[1]
    assert outs[0][:2] == (3, 4)


def test_control_channel_fifo_writers_reconnect(tmp_path):
    """A FIFO: writers connect, write lines and leave; the channel reopens
    and keeps listening; stop() releases a reader waiting for a writer."""
    fifo = str(tmp_path / "ctl.fifo")
    os.mkfifo(fifo)
    params = LiveParams()
    ch = control.ControlChannel(params, fifo, warn=lambda m: None).start()
    try:
        for k, line in enumerate(('{"attack": 0.7}', '{"release": 3.0}')):
            with open(fifo, "w") as f:
                f.write(line + "\n")
            wait_for(lambda: ch.applied == k + 1, f"line {k}")
        assert (params.attack, params.release) == (0.7, 3.0)
    finally:
        t0 = time.monotonic()
        thread = ch._thread
        ch.stop()
        assert time.monotonic() - t0 < 5.0 and not thread.is_alive()


def test_attach_control_applies_and_stops_with_the_stream(tmp_path):
    """Auralizer.attach_control: an update read before the run takes effect
    (PCM equal to run_offline with the updated params); the stream's stop()
    stops a channel waiting on an idle FIFO."""
    cfg = AuralizerConfig(channels=2, mip_level=2, ring_buffer_frames=16)
    frames = structured_frames(30, 4, 32, 64, mip=2)
    aur = Auralizer(source=frames, config=cfg, device="cpu")
    ch = aur.attach_control(io.StringIO('{"stereo_width": 0.0}\n'))
    wait_for(lambda: ch.applied == 1, "the update")
    aur.run_until_exhausted(timeout=TIMEOUT)
    got = aur.pull(4 * 2048 * 2)
    ref, _, _ = step.run_offline(frames, cfg,
                                 LiveParams(stereo_width=0.0).as_arrays(),
                                 device="cpu")
    np.testing.assert_array_equal(got, ref.numpy().reshape(-1))
    fifo = str(tmp_path / "idle.fifo")
    os.mkfifo(fifo)
    ch = aur.attach_control(fifo)
    thread = ch._thread
    aur.stop()
    thread.join(timeout=10)
    assert not thread.is_alive() and aur._stream._control is None


@pytest.mark.parametrize("full_heatmaps", [False, True])
def test_live_debug_renders_on_a_cpu_stream(tmp_path, full_heatmaps):
    """live_debug attached before start renders while the stream runs and
    after it ends; the final surface is byte for byte what the JAX
    package's render_debug_surface writes from the same debug state."""
    cfg = AuralizerConfig(mip_level=2, ring_buffer_frames=16)
    frames = structured_frames(31, 6, 32, 64, mip=2)
    aur = Auralizer(source=frames, config=cfg, device="cpu", debug=True)
    out = tmp_path / "live"
    renderer = aur.live_debug(str(out), every_frames=2,
                              full_heatmaps=full_heatmaps)
    try:
        aur.run_until_exhausted(timeout=TIMEOUT)
        wait_for(lambda: renderer.renders >= 1, "a render")
    finally:
        renderer.stop()
    names = {p.name for p in out.iterdir()}
    assert {"index.html", "hue_matrix.png", "input.png", "spectrum.png",
            "waveform.png", "grid_overlay.json"} <= names
    assert ("heatmap_hue_breathing.png" in names) == full_heatmaps
    assert b"http-equiv" not in (out / "index.html").read_bytes()
    dbg, frame = aur.debug, aur._stream.last_frame
    np.testing.assert_array_equal(frame, frames[-1])
    info = {"hues": dbg["hues"], "grads": dbg["grads"]}
    if full_heatmaps:
        info = dict(aur.inspect_frame(frame), hues=dbg["hues"])
    ref = jax_render.render_debug_surface(
        info, JaxConfig(mip_level=2, ring_buffer_frames=16),
        str(tmp_path / "ref"), spectrum=dbg["spectrum"], pcm=dbg["pcm"],
        input_frame=frame)
    for name, path in ref.items():
        assert (out / os.path.basename(path)).read_bytes() == \
            open(path, "rb").read(), name
    with pytest.raises(ValueError, match="debug=True"):
        Auralizer(config=cfg, device="cpu", debug=False).live_debug(
            str(tmp_path / "x"))


def test_last_frame_is_kept_only_with_debug():
    frames = structured_frames(32, 3, 32, 32, mip=2)
    cfg = AuralizerConfig(mip_level=2, ring_buffer_frames=16)
    for debug in (True, False):
        aur = Auralizer(source=frames, config=cfg, device="cpu",
                        debug=debug)
        aur.run_until_exhausted(timeout=TIMEOUT)
        last = aur._stream.last_frame
        if debug:
            np.testing.assert_array_equal(last, frames[-1])
            assert not np.shares_memory(last, frames)
        else:
            assert last is None

