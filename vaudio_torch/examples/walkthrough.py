"""API walkthrough: every public surface of the port in one runnable script
(a copy of ``examples/walkthrough.py``).

    python -m vaudio_torch.examples.walkthrough /tmp/out
    VAUDIO_PLATFORM=cpu python -m vaudio_torch.examples.walkthrough /tmp/out
"""

import os
import sys

import numpy as np


def main(outdir="/tmp/vaudio_torch_walkthrough", device=None):
    os.makedirs(outdir, exist_ok=True)

    from vaudio_torch.api import Auralizer
    from vaudio_torch.config import AuralizerConfig, LiveParams
    from vaudio_torch.io import hsb_frames
    from vaudio_torch.utils.display import (peak_shape_curve,
                                            spectrum_display)

    # --- 1. offline sonification (TutorialView-style synthetic input) ---
    aur = Auralizer(device=device)
    frames = hsb_frames(hue=0.33, saturation=1.0, brightness=1.0,
                        width=256, height=256, num_frames=30)  # 1s green
    wav = os.path.join(outdir, "green.wav")
    audio = aur.sonify_to_wav(frames, wav)
    print(f"[offline] {wav}: {len(audio)} samples "
          f"(expect ~440 Hz comb: hue 120 -> 220*2^1)")

    # --- 2. debug introspection (ConvolutionDebugView surface) ---
    d = aur.inspect_frame(frames[0])
    print(f"[inspect] hues={d['hues'][:4]}... "
          f"histogram peak bin={int(d['histogram'].sum(0).argmax())} "
          f"intensity-map shape={d['intensity_map'].shape}")

    # --- 3. streaming with live parameter changes ---
    params = LiveParams(spectrum_mixing=0.9, attack=0.8, release=0.3)
    live = Auralizer(params=params, debug=True, device=device)
    live.start(iter(frames))
    live.pull(4096)                              # audio-callback style
    params.spectrum_mixing = 0.2                 # live update
    live.run_until_exhausted(iter(frames))
    print(f"[stream] metrics: latency p50="
          f"{live.metrics['latency_p50_ms']:.1f}ms "
          f"buffer={live.metrics['buffer_fill']} "
          f"dropped={live.metrics['dropped_frames']}")

    # --- 4. checkpoint / resume ---
    ckpt = os.path.join(outdir, "state.npz")
    live.save_state(ckpt)
    resumed = Auralizer(device=device)
    resumed.load_state(ckpt)
    print(f"[checkpoint] saved+restored DSP state -> {ckpt}")
    live.stop()

    # --- 5. display-space curves (SpectrumView / VisualizePeak math) ---
    _, dbg = aur.sonify(frames[:4], debug=True)
    curve = spectrum_display(dbg["spectrum"][-1], aur.config)
    dpk, wpk = peak_shape_curve(bandwidth=1.0, q=4.0)
    print(f"[display] spectrum curve {curve['db'].shape}, "
          f"peak shape W(0)={wpk[len(wpk) // 2]:.2f}")

    # --- 6. stereo + filters extensions ---
    st = Auralizer(config=AuralizerConfig(channels=2, enable_filters=True),
                   params=LiveParams(hp_cutoff=100.0, lp_cutoff=8000.0,
                                     hp_order=4.0, lp_order=4.0),
                   device=device)
    st_wav = os.path.join(outdir, "stereo_filtered.wav")
    st.sonify_to_wav(frames[:10], st_wav)
    print(f"[stereo] {st_wav}: band-passed, column-panned")

    # --- 7. live stereo width (a live param, no rebuild) ---
    wide = Auralizer(config=AuralizerConfig(channels=2),
                     params=LiveParams(stereo_width=0.0), device=device)
    mono_img = wide.sonify(frames[:10])
    assert np.allclose(mono_img[:, 0], mono_img[:, 1], atol=1e-6)
    print(f"[width] stereo_width=0 -> dual mono verified "
          f"({mono_img.shape})")

    # --- 8. render the debug surface to PNGs (the CLI's debug command) ---
    from vaudio_torch.utils.render import render_debug_surface
    info = aur.inspect_frame(frames[-1])
    written = render_debug_surface(info, aur.config,
                                   os.path.join(outdir, "debug"),
                                   spectrum=dbg["spectrum"][-1])
    print(f"[render] {len(written)} debug artifacts "
          f"(heatmaps / hue matrix / spectrum)")

    # --- 9. chunk-batched offline mode (the throughput pipeline) ---
    fast = aur.sonify(frames, mode="chunked")
    slow = aur.sonify(frames, mode="scan")
    print(f"[chunked] max |chunked - scan| = "
          f"{np.abs(fast - slow).max():.2e} (same math, batched "
          f"synthesis)")

    print("walkthrough complete:", sorted(os.listdir(outdir)))


if __name__ == "__main__":
    from vaudio_torch.cli import platform_device
    main(*(sys.argv[1:2] or ["/tmp/vaudio_torch_walkthrough"]),
         device=platform_device())
