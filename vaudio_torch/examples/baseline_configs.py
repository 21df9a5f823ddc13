"""Runnable demonstrations of the five BASELINE.json capability configs on
the port (a copy of ``examples/baseline_configs.py``).

1. 64x64 frame -> oscillator-bank sonification
2. 720p still image -> sonification through the full render path
3. 1080p30 clip -> offline synthesis, 48 kHz mono PCM
4. Live stream with feature-modulated timbre, stereo out
5. Batched 8x concurrent streams over an 8-device mesh (the card's devices,
   repeated where it has fewer than 8)

    python -m vaudio_torch.examples.baseline_configs [1-5 | all]

(``VAUDIO_PLATFORM=cpu``: on the CPU, config 5 over a repeated CPU device).
"""

import os
import sys

import numpy as np


def config1_small_frame(tmpdir="/tmp", device=None):
    """64x64 solid frame -> sonification."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import solid_color_frames
    frames = solid_color_frames([0.8, 0.2, 0.2], 64, 64, 30)
    aur = Auralizer(device=device)
    path = os.path.join(tmpdir, "config1.wav")
    audio = aur.sonify_to_wav(frames, path)
    print(f"[1] 64x64 -> {path}: {len(audio)} samples")


def config2_720p_still(tmpdir="/tmp", device=None):
    """A 720p still held for 2 s through the full render path."""
    from vaudio_torch.api import Auralizer
    rng = np.random.default_rng(7)
    still = rng.uniform(0, 1, (720, 1280, 3)).astype(np.float32)
    frames = np.repeat(still[None], 60, axis=0)
    aur = Auralizer(device=device)
    path = os.path.join(tmpdir, "config2.wav")
    audio = aur.sonify_to_wav(frames, path)
    print(f"[2] 720p still -> {path}: {len(audio)} samples")


def config3_1080p_clip(tmpdir="/tmp", device=None):
    """1080p clip -> offline 48 kHz synthesis."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.config import AuralizerConfig
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (30, 1080, 1920, 3)).astype(np.float32)
    aur = Auralizer(config=AuralizerConfig(sample_rate=48000.0),
                    device=device)
    path = os.path.join(tmpdir, "config3.wav")
    audio = aur.sonify_to_wav(frames, path)
    print(f"[3] 1080p30 -> {path}: {len(audio)} samples @48k")


def config4_live_stream(tmpdir="/tmp", device=None):
    """Streaming mode: live source, gradient-modulated timbre, TRUE stereo
    (channels=2: cells pan by grid column, so an off-centre hue field
    produces a real L/R image)."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.io import write_wav

    def camera():  # synthetic "camera": hue sweep with moving gradient
        rng = np.random.default_rng(4)
        base = rng.uniform(0, 1, (270, 480, 3)).astype(np.float32)
        base[:, 240:, 0] = 1.0               # red mass on the right half
        for t in range(60):
            roll = np.roll(base, t * 4, axis=1)
            yield np.clip(roll * (0.6 + 0.4 * np.sin(t / 10)), 0, 1)

    cfg = AuralizerConfig(sample_rate=48000.0, channels=2)
    aur = Auralizer(config=cfg, realtime=False, debug=True, device=device)
    aur.run_until_exhausted(camera(), timeout=600)
    n = aur.metrics["buffer_fill"] * cfg.hop_size * cfg.channels
    stereo = aur.pull(n).reshape(-1, 2)      # interleaved -> (N, 2)
    path = os.path.join(tmpdir, "config4.wav")
    write_wav(path, stereo, 48000.0, channels=2)
    el, er = np.abs(stereo[:, 0]).sum(), np.abs(stereo[:, 1]).sum()
    print(f"[4] live stream -> {path}: {stereo.shape}, "
          f"L/R energy {el:.1f}/{er:.1f}, "
          f"p50 latency {aur.metrics['latency_p50_ms']:.1f} ms "
          f"(+{aur.metrics['hardware_latency_ms']:.1f} ms sink)")
    aur.stop()
    assert not np.isclose(el, er, rtol=1e-3), "expected a stereo image"


def config5_mesh_batch(tmpdir="/tmp", device=None, n_frames=10,
                       size=(270, 480)):
    """8 concurrent streams sharded over a (4, 2) mesh: the card's devices
    (or ``device``), repeated where there are fewer than 8.  Returns the
    audio, f32[8, n_frames * hop]."""
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.parallel import make_stream_mesh, run_offline_parallel
    from vaudio_torch.parallel.sharding import local_cards
    have = local_cards() if device is None else [device]
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (8, n_frames, *size, 3)).astype(np.float32)
    mesh = make_stream_mesh(4, 2, devices=[have[i % len(have)]
                                           for i in range(8)])
    audio, _, _ = run_offline_parallel(frames, AuralizerConfig(), mesh)
    audio = audio.cpu().numpy()
    print(f"[5] mesh batch: mesh={mesh.shape} over {len(have)} device(s) "
          f"audio {audio.shape}")
    return audio


if __name__ == "__main__":
    from vaudio_torch.cli import platform_device
    dev = platform_device()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    fns = {"1": config1_small_frame, "2": config2_720p_still,
           "3": config3_1080p_clip, "4": config4_live_stream,
           "5": config5_mesh_batch}
    for k, fn in fns.items():
        if which in ("all", k):
            fn(device=None if dev.type == "cuda" else str(dev))
