"""Command-line interface of the PyTorch/CUDA port — the counterpart of
:mod:`vaudio.cli`, with the same commands, flags, messages and exit codes.

Usage examples::

    python -m vaudio_torch sonify clip.npy -o out.wav
    python -m vaudio_torch synthetic --hue 0.33 --frames 90 -o green.wav
    python -m vaudio_torch info
    python -m vaudio_torch parity --frames 3 --size 128
    python -m vaudio_torch bench

Every command that computes runs on the card.  ``VAUDIO_PLATFORM=cpu``
runs it on the CPU instead (``VAUDIO_NUM_CPU_DEVICES=N`` then gives
``pod --mesh`` N repeated CPU devices); without a card and without that
variable such a command exits non-zero with :func:`vaudio_torch.device`'s
message.  ``push`` and ``pull`` are HTTP clients and pick no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _platform() -> str:
    return os.environ.get("VAUDIO_PLATFORM", "").strip().lower()


def platform_device():
    """The one device every object of this command runs on: the CPU when
    ``VAUDIO_PLATFORM=cpu``, else the card.  Without a card this exits
    with :func:`vaudio_torch.device`'s message; nothing falls back to the
    CPU quietly."""
    import vaudio_torch
    plat = _platform()
    if plat == "cpu":
        return vaudio_torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise SystemExit(f"VAUDIO_PLATFORM={plat!r}: expected cpu or cuda")
    try:
        vaudio_torch.device()
    except RuntimeError as e:
        raise SystemExit(f"vaudio_torch: {e} (or set VAUDIO_PLATFORM=cpu)")
    import torch
    # The current card by index, as the mesh devices name it.
    return torch.device("cuda", torch.cuda.current_device())


def _devices(dev) -> list:
    """The devices a mesh may lay its shards on: every card, or
    ``VAUDIO_NUM_CPU_DEVICES`` (default 1) CPU devices."""
    if dev.type == "cpu":
        return ["cpu"] * int(os.environ.get("VAUDIO_NUM_CPU_DEVICES") or 1)
    from vaudio_torch.parallel.sharding import local_cards
    return local_cards()


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sample-rate", type=float, default=44100.0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--mip-level", type=int, default=3)
    p.add_argument("--no-quirks", action="store_true",
                   help="use the clean phase layout instead of "
                        "reference-compatible quirk mode")
    p.add_argument("--pallas", action="store_true",
                   help="use the hand-written synthesis kernel (K2, the "
                        "Hann-peak contraction)")
    p.add_argument("--filters", action="store_true",
                   help="enable the HP/LP spectral filter (the reference "
                        "plumbs but never applies it)")
    p.add_argument("--channels", type=int, default=1, choices=(1, 2),
                   help="1 = mono (reference parity), 2 = stereo "
                        "(cells panned by grid column)")
    p.add_argument("--spectrum-mixing", type=float, default=0.9)
    p.add_argument("--attack", type=float, default=1.0)
    p.add_argument("--release", type=float, default=1.0)
    p.add_argument("--stereo-width", type=float, default=1.0,
                   help="pan-law width for --channels 2: 1 = full column "
                        "pan, 0 = dual mono, >1 widened")
    p.add_argument("--pan-angles", type=str, default=None,
                   help="comma-separated per-cell pan angles in [0, pi/2] "
                        "(num_cells values, row-major; 0 = hard left, "
                        "pi/2 = hard right) replacing the column pan law "
                        "for --channels 2")


def _build_config(args):
    from vaudio_torch.config import AuralizerConfig, LiveParams
    cfg = AuralizerConfig(sample_rate=args.sample_rate, video_fps=args.fps,
                          mip_level=args.mip_level,
                          quirk_compat=not args.no_quirks,
                          use_pallas=args.pallas,
                          channels=args.channels,
                          enable_filters=args.filters)
    pan_angles = None
    if getattr(args, "pan_angles", None):
        pan_angles = np.asarray(
            [float(v) for v in args.pan_angles.split(",")], np.float32)
        if pan_angles.shape != (cfg.num_cells,):
            raise SystemExit(
                f"--pan-angles needs {cfg.num_cells} comma-separated "
                f"values, got {pan_angles.size}")
    params = LiveParams(attack=args.attack, release=args.release,
                        spectrum_mixing=args.spectrum_mixing,
                        stereo_width=args.stereo_width,
                        pan_angles=pan_angles)
    return cfg, params


def _warn_orthomodes(cfg, params) -> None:
    """Say which CLI params the per-pixel family has no equivalent for
    (attack / release / spectrum_mixing map directly; the model is mono
    and unfiltered) — warn rather than silently drop."""
    if cfg.channels > 1:
        print("orthomodes: per-pixel model is mono; writing 1 channel",
              file=sys.stderr)
    ignored = [name for name, default in
               (("stereo_width", 1.0), ("pan_angles", None))
               if getattr(params, name) is not default] + \
              (["--filters"] if cfg.enable_filters else [])
    if ignored:
        print(f"orthomodes: no equivalent for {', '.join(ignored)}; "
              "ignored", file=sys.stderr)


def _sonify_orthomodes(cfg, params, frames, output, device):
    """Route a clip through the OrthoModes family (models/orthomodes.py),
    honouring the CLI params it supports.  The engine owns the config
    coercion and the LiveParams -> model-params mapping."""
    from vaudio_torch.api import Auralizer
    _warn_orthomodes(cfg, params)
    return Auralizer(config=cfg, params=params, model="orthomodes",
                     device=device).sonify_to_wav(frames, output)


def cmd_sonify(args) -> int:
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import ArraySource, VideoFileSource
    dev = platform_device()
    cfg, params = _build_config(args)
    if args.input.endswith((".npy", ".npz")):
        src = ArraySource.load(args.input, fps=args.fps)
        frames = src.tensor()
    else:
        frames = VideoFileSource(args.input, fps=args.fps).tensor()
    if getattr(args, "model", "auralizer") == "orthomodes":
        audio = _sonify_orthomodes(cfg, params, frames, args.output, dev)
    else:
        aur = Auralizer(config=cfg, params=params, device=dev)
        audio = aur.sonify_to_wav(frames, args.output)
    dur = len(audio) / cfg.sample_rate
    print(f"wrote {args.output}: {dur:.2f}s at {cfg.sample_rate:.0f} Hz "
          f"from {len(frames)} frames")
    return 0


def cmd_synthetic(args) -> int:
    from vaudio_torch.io import hsb_frames
    dev = platform_device()
    cfg, params = _build_config(args)
    frames = hsb_frames(args.hue, args.saturation, args.brightness,
                        width=args.width, height=args.height,
                        num_frames=args.frames)
    if args.model == "orthomodes":
        audio = _sonify_orthomodes(cfg, params, frames, args.output, dev)
    else:
        from vaudio_torch.api import Auralizer
        aur = Auralizer(config=cfg, params=params, device=dev)
        audio = aur.sonify_to_wav(frames, args.output)
    print(f"wrote {args.output}: {len(audio) / cfg.sample_rate:.2f}s "
          f"(hue={args.hue}, model={args.model})")
    return 0


def cmd_info(args) -> int:
    """The JAX command's ``config_defaults`` and ``derived``; in place of
    its backend and devices, torch's and CUDA's versions and the devices
    this CLI runs on."""
    import torch

    import vaudio_torch
    from vaudio_torch.config import AuralizerConfig
    dev = platform_device()
    cfg = AuralizerConfig()
    devices = ([str(dev)] if dev.type == "cpu" else
               [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())])
    info = {
        "version": vaudio_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": dev.type,
        "devices": devices,
        "config_defaults": {f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)},
        "derived": {"num_bins": cfg.num_bins, "hop_size": cfg.hop_size,
                    "bin_width": cfg.bin_width},
    }
    print(json.dumps(info, indent=2, default=str))
    return 0


def cmd_doctor(args) -> int:
    """Active environment health checks (vaudio_torch.utils.doctor): the
    card (watchdogged), the kernels' build, the native runtime library,
    decode backends, audio sinks, and an end-to-end sonify smoke, on the
    card unless ``--platform cpu`` or ``VAUDIO_PLATFORM=cpu``.  Exits 1 on
    any FAIL; warnings (missing optional capabilities) exit 0."""
    from vaudio_torch.utils.doctor import format_report, run_doctor
    platform = args.platform or ("cpu" if _platform() == "cpu" else None)
    checks = run_doctor(platform=platform, timeout=args.timeout,
                        skip_backend=args.skip_backend,
                        skip_smoke=args.skip_smoke,
                        smoke_timeout=args.smoke_timeout,
                        url=args.url, token=args.token)
    if args.json:
        print(json.dumps(checks, indent=2))
    else:
        print(format_report(checks))
    return 1 if any(c["status"] == "fail" for c in checks) else 0


def cmd_stream(args) -> int:
    """Raw frames in -> PCM stdout streaming (production pipe mode).

    Input is stdin by default, or any readable node via ``--input`` — a
    FIFO fed by a capture process, or a V4L2 device configured for a raw
    pixel format (the live-camera path, CameraModel.swift:12-37)::

        ffmpeg -i cam.mp4 -f rawvideo -pix_fmt rgb24 pipe:1 | \\
            python -m vaudio_torch stream --size 1080x1920 > out.pcm
        python -m vaudio_torch stream --input /dev/video0 --pix-fmt nv12 \\
            --size 1080x1920 > out.pcm
    """
    import contextlib
    import signal as _signal
    import time as _time

    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import (VIDEO_FILE_EXTENSIONS, RawVideoSource,
                                 VideoFileSource)
    from vaudio_torch.utils.profiling import trace_context
    dev = platform_device()
    cfg, params = _build_config(args)
    model = getattr(args, "model", "auralizer")
    if model == "orthomodes":
        _warn_orthomodes(cfg, params)
        if args.raw_yuv or args.pix_fmt != "rgb24":
            raise SystemExit("stream: the OrthoModes family is RGB-only "
                             "(no planar-YUV path); use --pix-fmt rgb24")
        if args.live_debug or args.debug_heatmaps:
            raise SystemExit("stream: the OrthoModes family has no cell "
                             "debug surface; use --serve for its live "
                             "spectrum/waveform views")
    aur = Auralizer(config=cfg, params=params, realtime=args.realtime,
                    debug=bool(args.live_debug or args.serve),
                    chunk_frames=args.chunk_frames,
                    metrics_log=args.metrics_log, model=model,
                    pipeline_depth=args.pipeline_depth, device=dev)
    cfg = aur.config          # orthomodes coerces channels/filters

    path = "/dev/stdin" if args.input == "-" else args.input
    if path == "push":
        # Network ingest: frames arrive over the --serve panel's HTTP
        # door (POST /frames; see `vaudio_torch push`).  block policy: the
        # producer thread paces on arrival, like a pipe read.
        if not args.serve:
            raise SystemExit("stream: --input push needs --serve "
                             "(frames arrive via POST /frames)")
        from vaudio_torch.io import PushSource
        src = PushSource(when_empty="block")
    elif path.startswith("cv2:"):
        # Live webcam through OpenCV's codecs (cv2:0 = default camera;
        # cv2:<anything-else> is passed to VideoCapture verbatim).
        from vaudio_torch.io import Cv2CameraSource
        dev_spec = path[4:]
        src = Cv2CameraSource(int(dev_spec) if dev_spec.isdigit()
                              else dev_spec, max_frames=args.max_frames)
    elif path.lower().endswith(VIDEO_FILE_EXTENSIONS):
        # Encoded clip (mp4/avi/...): decode in-process (cv2/ffmpeg);
        # the container self-describes, so --size is not needed.
        src = VideoFileSource(path)
        if args.max_frames:
            import itertools
            _vf = src

            class _Limited:                       # bounded .frames() view
                shape = _vf.shape

                def frames(self):
                    return itertools.islice(_vf.frames(), args.max_frames)
            src = _Limited()
    else:
        if not args.size:
            raise SystemExit(
                "stream: --size HxW is required for raw inputs "
                "(encoded video files self-describe)")
        h, w = (int(x) for x in args.size.split("x"))
        src = RawVideoSource(path, width=w, height=h, pix_fmt=args.pix_fmt,
                             fps=args.fps, raw=args.raw_yuv,
                             max_frames=args.max_frames,
                             zero_copy=args.zero_copy)
    if args.control:
        # Live runtime control: JSON lines on a FIFO/file mutating the
        # LiveParams mid-stream (the control-panel slider surface).
        aur.attach_control(args.control)
    live = None
    if args.live_debug:
        live = aur.live_debug(args.live_debug,
                              every_frames=args.debug_every,
                              full_heatmaps=args.debug_heatmaps)
    player = None
    if args.play:
        from vaudio_torch.io import SubprocessPlayer
        player = SubprocessPlayer(cfg.sample_rate, cfg.channels)
        print(f"stream: playing via {' '.join(player.command)}",
              file=sys.stderr)
    server = None
    if args.serve:
        host, _, port = args.serve.rpartition(":")
        server = aur.serve(port=int(port), host=host or "127.0.0.1",
                           token=args.token)
        print(f"stream: live control panel at {server.url}",
              file=sys.stderr)
    if args.load_state:
        # Resume a prior stream's DSP carry (runtime/checkpoint.py; a
        # checkpoint of either package) — the next frame continues
        # phases/EMA/OLA seamlessly.
        aur.load_state(args.load_state)
        print(f"stream: resumed DSP state from {args.load_state}",
              file=sys.stderr)
    # Graceful shutdown: SIGTERM (systemd stop, a supervisor's kill) and Ctrl-C
    # land in finish() below — PCM flushed, player/server/live surfaces
    # closed, --save-state honoured — instead of dying mid-write (the
    # reference's stop path is deliberate too, SoundEngine.swift:459-474).
    # The handler runs in the main thread, between bytecodes: the producer
    # thread's device calls are not interrupted.  Main thread only;
    # in-process callers keep their own handlers.
    _sig = {"n": 0}

    def _graceful(signum, frame):
        _sig["n"] = signum
        raise KeyboardInterrupt

    try:
        prev_term = _signal.signal(_signal.SIGTERM, _graceful)
    except ValueError:          # not the main thread
        prev_term = None

    trace = contextlib.ExitStack()
    if args.trace:
        # Device-level tracing at the front door: a torch.profiler trace
        # of the whole stream (CPU ops and, on the card, its kernels and
        # copies), viewable in TensorBoard/Perfetto — the deep version of
        # the per-frame latency probe (SoundEngine.swift:430-434).
        trace.enter_context(trace_context(args.trace, device=dev))
        print(f"stream: capturing torch.profiler trace to {args.trace}",
              file=sys.stderr)

    def finish() -> None:
        if args.trace:
            trace.close()
            print(f"stream: trace written to {args.trace}",
                  file=sys.stderr)
        if live is not None:
            live.stop()
        if player is not None:
            code = player.close()
            if code:
                print(f"stream: player exited with {code}",
                      file=sys.stderr)
        if server is not None:
            server.stop()
        if args.save_state:
            # BEFORE aur.stop(): stop clears the OLA tail (reference
            # quirk, runtime/stream.py); the carry reference is swapped
            # atomically per dispatch, so a live read on interrupt is
            # still a consistent snapshot.
            aur.save_state(args.save_state)
            print(f"stream: DSP state saved to {args.save_state}",
                  file=sys.stderr)
        aur.stop()
        if prev_term is not None:
            _signal.signal(_signal.SIGTERM, prev_term)

    def interrupt_rc() -> int:
        print("stream: interrupted; shutting down cleanly",
              file=sys.stderr)
        return 128 + (_sig["n"] or int(_signal.SIGINT))

    aur.start(src)              # duck-typed: anything with .frames()
    out = sys.stdout.buffer
    quantum = 2048 * cfg.channels
    hop_samples = cfg.hop_size * cfg.channels
    written = 0

    # Interactive serve mode: with --serve and stdout on a TTY, raw PCM
    # on the terminal is useless AND the stdout drain would steal every
    # sample from /audio.wav listeners — leave the ring to the server
    # (drop-on-full keeps it bounded, SoundEngine.swift:448) and just
    # babysit the producer.
    if server is not None and sys.stdout.isatty():
        rc = 0
        try:
            if player is not None:
                # --play is an explicit ask for speaker output: drive the
                # player from the ring at the real-time cadence.  The ring
                # is single-consumer, so /audio.wav listeners will mostly
                # read zero-fill while the player drains — say so.
                print("stream: stdout is a TTY; PCM goes to the --play "
                      "player (note: /audio.wav listeners share the same "
                      "ring and will be starved while --play drains)",
                      file=sys.stderr)
                while aur.is_running:
                    aur.raise_if_failed()
                    player.write(aur.pull(quantum))
                    _time.sleep(quantum / cfg.sample_rate / cfg.channels
                                * 0.9)
            else:
                print("stream: stdout is a TTY; PCM goes to /audio.wav "
                      "listeners only (pipe stdout to also capture it)",
                      file=sys.stderr)
                while aur.is_running:
                    aur.raise_if_failed()
                    _time.sleep(0.05)
            aur.raise_if_failed()
            print(f"stream: source exhausted; metrics: {aur.metrics}",
                  file=sys.stderr)
        except KeyboardInterrupt:
            rc = interrupt_rc()
        finally:
            # Also on producer failure (raise_if_failed): the error
            # propagates loudly, but the trace must stop and
            # --save-state must still capture the consistent carry.
            finish()
        return rc

    def emit(pcm) -> int:
        out.write(pcm.astype("<f4").tobytes())
        if player is not None:
            player.write(pcm)
        return len(pcm)

    rc = 0
    try:
        while True:
            aur.raise_if_failed()
            m = aur.metrics
            fill, running = m["buffer_fill"], aur.is_running
            if args.realtime:
                # Real-time contract: pull at the hardware cadence;
                # underruns legitimately emit silence
                # (SoundEngine.swift:184-189).
                if not running and fill == 0:
                    break
                written += emit(aur.pull(quantum))
                _time.sleep(quantum / cfg.sample_rate / cfg.channels
                            * 0.9)
                continue
            # Free-running pipe mode: emit only REAL samples — pulling
            # while the producer is still computing would stream
            # zero-fill to the pipe at CPU speed (gigabytes of silence
            # while the first dispatch loads the kernels).
            if fill == 0:
                if not running:
                    break
                _time.sleep(0.002)
                continue
            if not m["warmed_up"] and fill < cfg.warmup_frames:
                if running:    # warm-up in progress
                    _time.sleep(0.002)
                    continue
                break          # producer ended below warm-up: undrainable
            written += emit(aur.pull(min(quantum, fill * hop_samples)))
    except KeyboardInterrupt:
        rc = interrupt_rc()
    finally:
        # Also on producer failure (raise_if_failed): the error
        # propagates loudly, but the PCM written so far must flush and
        # --save-state must still capture the consistent carry.
        out.flush()
        print(f"stream: {written / cfg.sample_rate / cfg.channels:.2f}s "
              f"of PCM written; metrics: {aur.metrics}", file=sys.stderr)
        finish()
    return rc


def _open_frame_iter(path: str, *, width: int, height: int,
                     pix_fmt: str = "rgb24", fps: float = 30.0,
                     max_frames=None):
    """One frame iterable from a CLI input spec (shared by ``pod`` and
    ``push``): ``cv2:N`` = live webcam, ``.npy``/``.npz`` = clip tensor,
    an encoded video file (decoded in-process), or a raw video
    file/FIFO/device node in ``pix_fmt`` at ``width``x``height``."""
    from vaudio_torch.io import (VIDEO_FILE_EXTENSIONS, ArraySource,
                                 RawVideoSource, VideoFileSource)
    if path.startswith("cv2:"):
        from vaudio_torch.io import Cv2CameraSource
        dev = path[4:]
        return Cv2CameraSource(int(dev) if dev.isdigit() else dev,
                               max_frames=max_frames).frames()
    if path.endswith((".npy", ".npz")):
        return ArraySource.load(path, fps=fps).frames()
    if path.lower().endswith(VIDEO_FILE_EXTENSIONS):
        # Encoded clip: decoded in-process; a pod's static shape
        # contract still applies (a wrong-size clip fails loudly).
        it = VideoFileSource(path).frames()
        if max_frames:
            import itertools
            it = itertools.islice(it, max_frames)
        return it
    if width is None or height is None:
        raise SystemExit(f"raw input {path!r} needs --size HxW")
    return RawVideoSource(path, width=width, height=height,
                          pix_fmt=pix_fmt, fps=fps,
                          max_frames=max_frames).frames()


def _parse_mesh(spec: str, n_inputs: int):
    """``--mesh DP[xTP]`` -> (dp, tp), with the JAX command's messages."""
    dp, _, tp = spec.lower().partition("x")
    try:
        dp, tp = int(dp), int(tp or 1)
    except ValueError:
        raise SystemExit(f"pod: --mesh must be DP or DPxTP (e.g. "
                         f"4 or 4x2), got {spec!r}")
    if dp < 1 or tp < 1:
        raise SystemExit(f"pod: --mesh axes must be >= 1, got {spec!r}")
    if n_inputs % dp:
        raise SystemExit(f"pod: {n_inputs} inputs is not a "
                         f"multiple of the --mesh stream axis {dp}")
    return dp, tp


def cmd_pod(args) -> int:
    """Multi-stream serving pod: N raw-video inputs -> N WAV files
    through ONE batched device step per tick
    (vaudio_torch.runtime.multistream.MultiStreamAuralizer) — the
    production batch-serving front door.  All inputs must share --size and
    --pix-fmt (a pod serves one static shape; see the module docs).

        python -m vaudio_torch pod --size 64x64 -o out/ \\
            --input a.rgb --input b.rgb --input c.rgb

    ``--input push`` (or ``push:dark``) arms a slot for NETWORK ingest
    instead: clients feed it over the --serve panel's HTTP door
    (``POST /slots/<i>/frames``; see ``python -m vaudio_torch push``) and
    the slot idles dark until frames arrive."""
    import time as _time

    from vaudio_torch.io import write_wav
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import make_engine
    from vaudio_torch.utils.profiling import trace_context
    cfg, params = _build_config(args)
    if not args.input:
        raise SystemExit("pod: need at least one --input")
    model = getattr(args, "model", "auralizer")
    if model == "orthomodes":
        _warn_orthomodes(cfg, params)
        if args.pix_fmt != "rgb24":
            raise SystemExit("pod: the OrthoModes family is RGB-only "
                             "(no planar-YUV path); use --pix-fmt rgb24")
    h, w = (int(x) for x in args.size.split("x"))

    push_slots = {}             # slot index -> when_empty policy
    for i, path in enumerate(args.input):
        if path == "push" or path.startswith("push:"):
            policy = path.partition(":")[2] or "hold"
            if policy not in ("hold", "dark"):
                raise SystemExit(f"pod: --input {path!r}: push policy "
                                 "must be 'hold' or 'dark'")
            push_slots[i] = policy

    def open_source(path, i):
        if i in push_slots:
            # Placeholder: arm_push replaces it before the first tick.
            return iter(())
        return _open_frame_iter(path, width=w, height=h,
                                pix_fmt=args.pix_fmt, fps=args.fps,
                                max_frames=args.max_frames)

    n = len(args.input)
    multihost = (args.num_processes or 1) > 1
    mesh = None
    if multihost:
        # One pod spanning processes (parallel.hostpod.MultiHostPod): this
        # process serves the slots its mesh rows hold; the processes tick
        # in lockstep over a Gloo group.
        if args.mesh:
            raise SystemExit(
                "pod: --mesh is the single-host DP[xTP] layout; "
                "multi-host pods build their mesh from the joined "
                "processes automatically")
        if args.coordinator is None or args.process_id is None:
            raise SystemExit("pod: multi-host needs --coordinator and "
                             "--process-id with --num-processes")
        for bad, name in ((args.max_streams, "--max-streams"),
                          (args.idle_shrink, "--idle-shrink")):
            if bad is not None:
                raise SystemExit(
                    f"pod: {name} needs elastic capacity, which "
                    "multi-host pods do not have (capacity is static; "
                    "scale by adding pods)")
        if args.pix_fmt != "rgb24":
            raise SystemExit(
                "pod: multi-host pods are rgb24-only for now (the "
                "static frame template is built from --size)")
    elif args.mesh:
        dp, tp = _parse_mesh(args.mesh, n)
    dev = platform_device()
    os.makedirs(args.output, exist_ok=True)
    engine = make_engine(model, cfg, device=dev)   # coerces cfg itself
    cfg = engine.cfg
    if multihost:
        from vaudio_torch.parallel import (MultiHostPod, init_distributed,
                                           make_multihost_mesh)
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
        n_global = args.global_streams or n * args.num_processes
        pod = MultiHostPod(
            cfg, n_global,
            # uint8 template: the raw rgb24 readers (and 'push' clients
            # sending u8) match it; float sources would violate the pod's
            # static dtype contract loudly per slot.
            frame=np.zeros((h, w, 3), np.uint8),
            mesh=make_multihost_mesh(devices=_devices(dev)),
            realtime=args.realtime, chunk_frames=args.chunk_frames,
            metrics_log=args.metrics_log, engine=engine,
            lease_timeout=args.lease_timeout)
        if n != pod.n_streams:
            raise SystemExit(
                f"pod: this host serves {pod.n_streams} slots (global "
                f"{n_global} over {args.num_processes} processes) but "
                f"got {n} --input")
        # Per-slot CLI-seeded params (per-slot params shard with the
        # streams on the multi-host path — no shared-object restriction).
        pod.params = [dataclasses.replace(params)
                      for _ in range(pod.n_streams)]
        print(f"pod: multi-host process {args.process_id}/"
              f"{args.num_processes}: global slots "
              f"{pod.local_slice.start}..{pod.local_slice.stop - 1} "
              "served here", file=sys.stderr)
    else:
        if args.mesh:
            # Multi-device serving at the front door: shard the pod's
            # stream axis (and, for the flagship, the synthesis cells)
            # over a device mesh — `--mesh 4` = DP over 4 devices,
            # `--mesh 4x2` = DP x TP over 8.  Where there are fewer
            # devices than shards, they repeat (as dryrun_multichip does).
            from vaudio_torch.parallel import make_stream_mesh
            avail = _devices(dev)
            k = dp * tp
            if k <= len(avail):
                where = f"{k} of {len(avail)} devices"
            else:
                where = (f"{k} shards over {len(avail)} device(s), each "
                         "repeated")
            mesh = make_stream_mesh(
                dp, tp, devices=[avail[i % len(avail)] for i in range(k)])
            print(f"pod: device mesh stream={dp} cell={tp} ({where})",
                  file=sys.stderr)
        # CLI flags seed an INDEPENDENT LiveParams per slot, so --serve can
        # control each serving slot separately.  Mesh pods replicate ONE
        # shared LiveParams instead (the parallel steps replicate params;
        # the panel reports "shared": true).
        pod = MultiStreamAuralizer(
            cfg, n_streams=n,
            params=(params if mesh is not None else
                    [dataclasses.replace(params) for _ in range(n)]),
            mesh=mesh,
            realtime=args.realtime,
            chunk_frames=args.chunk_frames,
            metrics_log=args.metrics_log,
            engine=engine,
            max_streams=args.max_streams,
            lease_timeout=args.lease_timeout,
            idle_shrink=args.idle_shrink)
    cfg = pod.cfg               # engine may coerce (mono orthomodes)
    server = None
    if args.serve:
        host, _, port = args.serve.rpartition(":")
        server = pod.serve(port=int(port), host=host or "127.0.0.1",
                           token=args.token)
        print(f"pod: live panel at {server.url}", file=sys.stderr)
    if push_slots:
        if server is None:
            raise SystemExit("pod: --input push needs --serve (frames "
                             "arrive via POST /slots/<i>/frames)")
        if not args.realtime:
            print("pod: note: push slots without --realtime re-process "
                  "held frames at device speed; live serving wants "
                  "--realtime", file=sys.stderr)
        for i, policy in push_slots.items():
            pod.arm_push(i, when_empty=policy)
            print(f"pod: slot {i} armed for push ingest "
                  f"(POST {server.url}slots/{i}/frames; policy "
                  f"{policy})", file=sys.stderr)
    if args.load_state:
        # Resume every slot's DSP carry (runtime/checkpoint.py,
        # n_streams-validated) — the next tick continues each stream.
        pod.load_state(args.load_state)
        print(f"pod: resumed DSP state from {args.load_state}",
              file=sys.stderr)
    with trace_context(args.trace, device=dev):
        pod.start([open_source(p, i) for i, p in enumerate(args.input)])

        # Drain every slot's ring while the pod runs (the rings are
        # drop-on-full real-time sinks, SoundEngine.swift:448 — an
        # undrained slot would drop frames once 16 hops deep).  Only
        # warmed slots with buffered REAL samples are pulled, so
        # nothing here is zero-fill.
        hop_samples = cfg.hop_size * cfg.channels
        collected = [[] for _ in range(n)]
        while True:
            pod.raise_if_failed()
            running = pod.is_running
            drained_any = False
            # The panel can elastically resize a running pod (POST
            # /resize): track the live slot count — grown slots get
            # their own collectors/WAVs, shrunk slots stop draining
            # (their collected audio is still written below).
            while len(collected) < pod.n_streams:
                collected.append([])
            for i in range(pod.n_streams):
                try:
                    ring = pod.rings[i]
                except IndexError:
                    break            # elastic shrink landed mid-sweep

                def _pull_ready(ring=ring, i=i):
                    fill = ring.available
                    if fill and (ring.warmed_up
                                 or fill >= cfg.warmup_frames):
                        return pod.pull(i, fill * hop_samples)
                    return None
                if server is not None:
                    # Pull under the slot's audio lock: a
                    # /slots/<i>/audio.wav listener owns the ring while
                    # connected (concurrent pulls would split samples) —
                    # the WAV file misses the listened span.
                    chunk = server.drain_exclusive(i, _pull_ready)
                else:
                    chunk = _pull_ready()
                if chunk is not None:
                    collected[i].append(chunk)
                    drained_any = True
            if not running and not drained_any:
                break
            if not drained_any:
                _time.sleep(0.002)
    for i, chunks in enumerate(collected):
        path = args.input[i] if i < len(args.input) else "(resized in)"
        pcm = (np.concatenate(chunks) if chunks
               else np.zeros(0, np.float32))
        if cfg.channels > 1:
            pcm = pcm.reshape(-1, cfg.channels)
        out_path = os.path.join(args.output, f"slot{i}.wav")
        write_wav(out_path, pcm, cfg.sample_rate, channels=cfg.channels)
        dropped = (pod.stream_metrics(i)["dropped_frames"]
                   if i < pod.n_streams else "n/a")
        print(f"pod slot {i}: {path} -> {out_path} "
              f"({len(pcm) / cfg.sample_rate:.2f}s, "
              f"dropped={dropped})", file=sys.stderr)
    agg = pod.metrics
    print(f"pod: {agg.frames_processed} frames over {pod.n_streams} "
          f"streams in {agg.dispatches} dispatches", file=sys.stderr)
    if args.save_state:
        # BEFORE pod.stop(): stop clears the OLA tails (the reference's
        # stop semantics, SoundEngine.swift:459-474).
        pod.save_state(args.save_state)
        print(f"pod: DSP state saved to {args.save_state}",
              file=sys.stderr)
    if server is not None:
        server.stop()
    pod.stop()
    if multihost:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def cmd_push(args) -> int:
    """Feed frames to a REMOTE serving pod over HTTP — the client half
    of the network-ingest door (the pod side is ``pod --serve ... --input
    push``; vaudio_torch.runtime.podserver POST /slots/<i>/frames).
    Host-side numpy + urllib: picks no device.

        python -m vaudio_torch push --url http://pod-host:8000 --slot 0 \\
            --input clip.mp4 --realtime

    Repeating ``--url`` with ``--slot acquire`` places the lease across
    a FLEET of pods (most capacity first; vaudio_torch.client.FleetClient)
    and pushes to wherever it landed.
    """
    from vaudio_torch.io.push import push_frames
    w = h = None
    if args.size:
        h, w = (int(x) for x in args.size.split("x"))
    frames = _open_frame_iter(args.input, width=w, height=h,
                              pix_fmt=args.pix_fmt, fps=args.fps,
                              max_frames=args.max_frames)
    if args.stream:
        slot = None
    elif args.slot == "acquire":
        slot = "acquire"
    else:
        try:
            slot = int(args.slot)
        except ValueError:
            raise SystemExit(f"push: --slot must be an integer or "
                             f"'acquire', got {args.slot!r}")
    if slot is None and (args.when_empty != "hold" or args.maxsize != 8
                         or args.reset):
        # Single-stream panels configure their PushSource at launch
        # (block policy, fixed queue) — silently ignoring the requested
        # queue policy would be worse than refusing.
        raise SystemExit(
            "push: --when-empty/--maxsize/--reset configure a POD "
            "slot's queue at arm time; a single-stream panel "
            "(--stream) is armed at launch and cannot be re-armed "
            "remotely")
    url = args.url[0]
    arm = not args.no_arm
    if len(args.url) > 1:
        # Fleet mode: place the lease on the most-capacity pod, then
        # push to wherever it landed.
        if slot != "acquire":
            raise SystemExit("push: multiple --url need --slot acquire "
                             "(the fleet chooses the pod AND the slot)")
        import itertools

        from vaudio_torch.client import FleetClient
        # Peek the first frame so placement is SHAPE-AWARE: a
        # mixed-resolution fleet must route this clip to a pod of ITS
        # shape (capacity-only placement would land on a wrong-shape
        # pod whose door then rejects every frame).
        frames = iter(frames)
        first = next(frames, None)
        if first is None:
            raise SystemExit("push: input produced no frames")
        frames = itertools.chain([first], frames)
        leased = FleetClient(args.url, retries=args.retries,
                             retry_wait=args.retry_wait,
                             token=args.token).acquire(
            maxsize=args.maxsize, when_empty=args.when_empty,
            reset=True,       # a lease always starts with a cold carry
            frame=first)
        url, slot = leased.client.url, leased.index
        # acquire already armed the slot with the LEASED PushSource —
        # re-arming would replace it with a non-leased one and exempt a
        # dead-before-first-frame client from --lease-timeout reaping.
        arm = False
        print(f"push: fleet leased slot {slot} on {url}",
              file=sys.stderr)
    sent = push_frames(url, slot, frames,
                       fps=args.fps if args.realtime else None,
                       arm=arm, when_empty=args.when_empty,
                       maxsize=args.maxsize, reset=args.reset,
                       close=not args.no_close, retries=args.retries,
                       retry_wait=args.retry_wait, token=args.token)
    target = "stream" if slot is None else f"slot {slot}"
    print(f"push: {sent} frames -> {url} {target}", file=sys.stderr)
    return 0


def cmd_pull(args) -> int:
    """Pull live audio from a remote deployment's speaker door — the
    client half of the pull-model audio contract (the reference's
    AVAudioSourceNode pull, SoundEngine.swift:156-228, across the
    network): a pod slot's ``GET /slots/<i>/audio.wav`` or a
    single-stream panel's ``GET /audio.wav``, recorded to a local WAV
    and/or played through a local speaker.  Host-side (numpy + urllib):
    picks no device.

        python -m vaudio_torch pull --url http://pod-host:8000 --slot 0 \\
            --seconds 10 -o slot0.wav
    """
    from vaudio_torch.client import PodClient, StreamClient
    if not args.output and not args.play:
        raise SystemExit("pull: nothing to do — give -o WAV and/or "
                         "--play")
    if args.stream:
        stream = StreamClient(args.url, retries=args.retries,
                              token=args.token).audio()
    else:
        stream = PodClient(args.url, retries=args.retries,
                           token=args.token).slot(args.slot).audio()
    player = None
    if args.play:
        from vaudio_torch.io import SubprocessPlayer
        player = SubprocessPlayer(stream.sample_rate, stream.channels)
    want = (None if args.seconds is None
            else int(round(args.seconds * stream.sample_rate)))
    parts, got = [], 0
    try:
        with stream:
            for chunk in stream:
                if player is not None:
                    player.write(chunk)
                if args.output:
                    parts.append(chunk)
                got += len(chunk)
                if want is not None and got >= want:
                    break
    except KeyboardInterrupt:
        pass
    finally:
        if player is not None:
            player.close()
    if args.output:
        from vaudio_torch.io import write_wav
        pcm = (np.concatenate(parts) if parts
               else np.zeros((0, stream.channels), np.float32))
        if want is not None:
            pcm = pcm[:want]
        write_wav(args.output, pcm, sample_rate=stream.sample_rate,
                  channels=stream.channels)
        print(f"pull: wrote {len(pcm)} samples "
              f"({len(pcm) / stream.sample_rate:.2f}s at "
              f"{stream.sample_rate} Hz, {stream.channels}ch) to "
              f"{args.output}", file=sys.stderr)
    return 0


def cmd_debug(args) -> int:
    """Render the debug surface (the ConvolutionDebugView / SpectrumView /
    TimeDomainFrameView equivalents) for a frame or short clip to PNGs:
    per-pixel signed mode heatmaps for H/S/I, the 4x4 dominant-hue matrix,
    the log-dB spectrum and the output waveform."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import (VIDEO_FILE_EXTENSIONS, ArraySource,
                                 VideoFileSource, hsb_frames)
    from vaudio_torch.utils.render import render_debug_surface
    dev = platform_device()
    cfg, params = _build_config(args)
    if args.input == "synthetic":
        frames = hsb_frames(args.hue, args.saturation, args.brightness,
                            num_frames=args.frames)
    elif args.input.lower().endswith(VIDEO_FILE_EXTENSIONS):
        frames = VideoFileSource(args.input).tensor()
    else:
        frames = ArraySource.load(args.input).tensor()
        if frames.ndim == 3:
            frames = frames[None]
    aur = Auralizer(config=cfg, params=params, device=dev)
    pcm, dbg = aur.sonify(frames, debug=True)
    hop = cfg.hop_size

    info = aur.inspect_frame(frames[-1])
    # The hue matrix shows the stream-smoothed hues after the whole clip,
    # not a from-zero re-analysis of the last frame.
    info["hues"] = dbg["hues"][-1]
    written = render_debug_surface(
        info, cfg, args.output,
        spectrum=dbg["spectrum"][-1],
        pcm=pcm[-hop:] if cfg.channels == 1 else pcm[-hop:, :])
    print(f"wrote {len(written)} debug artifacts to {args.output}:")
    for name in sorted(written):
        print(f"  {name}: {written[name]}")
    return 0


def cmd_parity(args) -> int:
    """The port against the reference's literal f64 math on the JAX
    harness's own input (``benchmarks/parity.py``): ``--frames`` random
    f32 frames of ``--size``^2 from seed 0 and ``AuralizerConfig()``,
    through the per-frame runner, in process; the harness's lines, and
    exit 0 on PASS, 1 on FAIL."""
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.utils.parity import run_parity
    dev = platform_device()
    n, size = args.frames, args.size
    frames = np.random.default_rng(0).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)
    print(f"parity: {n} frames of {size}x{size} ...")
    rep = run_parity(frames, AuralizerConfig(), dev)
    err = rep["max_abs_err"]
    print(f"hues identical:      {rep['hues_identical']}")
    print(f"grads max |err|:     {err['grads']:.3e}")
    print(f"spectrum max |err|:  {err['spectrum']:.3e}")
    print(f"pcm max |err|:       {err['pcm']:.3e}  (pcm peak ~1.0)")
    print("PARITY:", "PASS" if rep["ok"] else "FAIL")
    return 0 if rep["ok"] else 1


def cmd_bench(args) -> int:
    """The port's headline benchmark (:mod:`vaudio_torch.bench`), in this
    process; its settings come from the ``VAUDIO_BENCH_*`` variables."""
    from vaudio_torch.bench import main as bench_main
    return bench_main()


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: one subcommand each, the JAX CLI's flags (its
    ``bench`` runs the port's benchmark, :mod:`vaudio_torch.bench`, in
    process, where the JAX CLI runs ``bench.py`` in a subprocess)."""
    ap = argparse.ArgumentParser(
        prog="vaudio_torch",
        description="video sonifier on an NVIDIA GPU (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sonify", help="sonify a video tensor/file to WAV")
    p.add_argument("input", help=".npy/.npz frame tensor or video file")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--model", choices=("auralizer", "orthomodes"),
                   default="auralizer",
                   help="model family: the flagship 16-cell pipeline or "
                        "the per-pixel A/Q/f0 OrthoModes synthesis")
    _add_config_args(p)
    p.set_defaults(fn=cmd_sonify)

    p = sub.add_parser("synthetic",
                       help="sonify synthetic solid-color frames "
                            "(tutorial-screen equivalent)")
    p.add_argument("--hue", type=float, default=0.0)
    p.add_argument("--saturation", type=float, default=1.0)
    p.add_argument("--brightness", type=float, default=1.0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--model", choices=("auralizer", "orthomodes"),
                   default="auralizer",
                   help="model family: the flagship 16-cell pipeline or "
                        "the per-pixel OrthoModes synthesis")
    p.add_argument("-o", "--output", default="synthetic.wav")
    _add_config_args(p)
    p.set_defaults(fn=cmd_synthetic)

    p = sub.add_parser("info", help="print environment + config info")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="run the benchmark")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("doctor",
                       help="active environment health checks "
                            "(backend/kernels/native/decode/player/smoke)")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="probe/smoke this device instead of the card "
                        "(cpu: no card needed)")
    p.add_argument("--timeout", type=float, default=90.0,
                   help="backend-probe watchdog seconds (default 90)")
    p.add_argument("--smoke-timeout", type=float, default=300.0,
                   help="kernel-build and end-to-end smoke watchdog "
                        "seconds (default 300)")
    p.add_argument("--skip-backend", action="store_true",
                   help="skip the card probe")
    p.add_argument("--skip-smoke", action="store_true",
                   help="skip the end-to-end sonify smoke")
    p.add_argument("--json", action="store_true",
                   help="emit the checks as JSON instead of text")
    p.add_argument("--url", default=None, metavar="URL",
                   action="append",
                   help="also health-check a RUNNING deployment's HTTP "
                        "panel (stream or pod --serve): serving state, "
                        "failed slots, latency; repeat for a fleet "
                        "(one panel row per pod)")
    p.add_argument("--token",
                   default=os.environ.get("VAUDIO_TOKEN"),
                   help="bearer token for a --url panel started with "
                        "--token (also env VAUDIO_TOKEN)")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("stream",
                       help="frames (stdin/FIFO/device node/video file) "
                            "-> f32 PCM on stdout")
    p.add_argument("--size", default=None,
                   help="HxW of incoming frames (required for raw "
                        "inputs; encoded video files self-describe)")
    p.add_argument("--input", default="-",
                   help="frame source: '-' = stdin, a file/FIFO/"
                        "capture-device node in a raw pixel format, "
                        "an encoded video file (.mp4/.avi/... decoded "
                        "in-process), cv2:N — live webcam N via "
                        "OpenCV (handles compressed MJPEG/H.264 cams), "
                        "or 'push' — network ingest via the --serve "
                        "panel's POST /frames (see 'vaudio_torch push')")
    p.add_argument("--pix-fmt", default="rgb24",
                   choices=("rgb24", "i420", "nv12"),
                   help="incoming raw pixel format")
    p.add_argument("--raw-yuv", action="store_true",
                   help="ship planar YUV to the device and convert "
                        "there (half the ingest bytes; YUV formats "
                        "only)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop after N frames (live device nodes never "
                        "EOF)")
    p.add_argument("--realtime", action="store_true",
                   help="pace at --fps instead of max throughput")
    p.add_argument("--zero-copy", action="store_true",
                   help="zero-copy ingest: frames are NumPy views over "
                        "the native reader's buffer pool (saves a "
                        "frame-sized memcpy per frame; a chunked stream "
                        "copies the frames it holds)")
    p.add_argument("--control", default=None, metavar="PATH",
                   help="JSON-lines live-control feed (FIFO or file): "
                        "each line is an object of LiveParams updates "
                        "applied mid-stream, e.g. "
                        '{"attack": 0.2, "stereo_width": 0}')
    p.add_argument("--live-debug", default=None, metavar="DIR",
                   help="re-render the debug surface (PNGs + auto-"
                        "refreshing index.html) to DIR while streaming")
    p.add_argument("--debug-every", type=int, default=30,
                   help="live-debug re-render cadence in processed frames")
    p.add_argument("--debug-heatmaps", action="store_true",
                   help="include per-pixel mode heatmaps in the live "
                        "debug surface (one extra device dispatch per "
                        "render)")
    p.add_argument("--play", action="store_true",
                   help="also play the PCM through a system audio player "
                        "(aplay/pw-play/paplay/ffplay or $VAUDIO_PLAYER)")
    p.add_argument("--serve", default=None, metavar="[HOST:]PORT",
                   help="serve the live HTTP control panel (sliders "
                        "mutating LiveParams mid-stream, refreshing hue/"
                        "spectrum/waveform views, /audio.wav live "
                        "listen) on this port while streaming")
    p.add_argument("--token",
                   default=os.environ.get("VAUDIO_TOKEN"),
                   help="bearer token for the HTTP panel (also env "
                        "VAUDIO_TOKEN): when set, every endpoint "
                        "requires 'Authorization: Bearer' or '?token='")
    p.add_argument("--load-state", default=None, metavar="NPZ",
                   help="resume the DSP carry (phases, previous "
                        "spectrum, OLA tail, AGC envelope, hues) from a "
                        "checkpoint before streaming")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="checkpoint the DSP carry to NPZ when the "
                        "stream ends (pair with --load-state to resume "
                        "a stream seamlessly across runs)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the whole "
                        "stream to DIR (TensorBoard/Perfetto format)")
    p.add_argument("--chunk-frames", type=int, default=1, metavar="N",
                   help="frames per device dispatch: 1 = lowest "
                        "latency, >1 = the chunk-batched throughput "
                        "pipeline (amortizes dispatch overhead N-fold "
                        "at the cost of N-1 frame times of buffering)")
    p.add_argument("--pipeline-depth", type=int, default=4, metavar="K",
                   help="dispatched device steps allowed in flight "
                        "awaiting PCM readback (a drain thread fetches "
                        "them in order)")
    p.add_argument("--model", choices=("auralizer", "orthomodes"),
                   default="auralizer",
                   help="model family: the flagship 16-cell synthesis "
                        "or the per-pixel OrthoModes synthesis (mono, "
                        "RGB-only; attack/release/mixing stay live)")
    p.add_argument("--metrics-log", default=None, metavar="JSONL",
                   help="append one JSONL metrics record per dispatch "
                        "(timestamp, frames, latency, buffer fill) for "
                        "offline analysis")
    _add_config_args(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("pod",
                       help="multi-stream serving pod: N inputs -> N "
                            "WAVs via one batched dispatch per tick")
    p.add_argument("--size", required=True, help="HxW of incoming frames "
                                                 "(shared by all inputs)")
    p.add_argument("--input", action="append", default=[],
                   metavar="PATH",
                   help="frame source (repeatable, one per serving "
                        "slot): raw video file/FIFO, .npy/.npz clip "
                        "tensor, encoded video, cv2:N webcam, or "
                        "'push'/'push:dark' — a network-ingest slot "
                        "fed over HTTP (needs --serve; see "
                        "'vaudio_torch push')")
    p.add_argument("--pix-fmt", default="rgb24",
                   choices=("rgb24", "i420", "nv12"))
    p.add_argument("--chunk-frames", type=int, default=1,
                   help="frames per stream per dispatch (>1 = the "
                        "chunk-batched throughput pipeline)")
    p.add_argument("--metrics-log", default=None, metavar="JSONL",
                   help="append one JSONL metrics record per dispatch "
                        "(timestamp, real frames, latency, per-slot "
                        "state) for offline analysis")
    p.add_argument("--model", choices=("auralizer", "orthomodes"),
                   default="auralizer",
                   help="model family served by the pod: the flagship "
                        "16-cell synthesis or the per-pixel OrthoModes "
                        "synthesis (mono, RGB-only)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--realtime", action="store_true",
                   help="pace ticks at --fps (live serving) instead of "
                        "max throughput")
    p.add_argument("--serve", default=None, metavar="[HOST:]PORT",
                   help="start the pod's live HTTP observability/control "
                        "panel (per-slot views, sliders, audio)")
    p.add_argument("--token",
                   default=os.environ.get("VAUDIO_TOKEN"),
                   help="bearer token for the HTTP panel (also env "
                        "VAUDIO_TOKEN): when set, every endpoint "
                        "requires 'Authorization: Bearer' or '?token='")
    p.add_argument("--max-streams", type=int, default=None,
                   help="growth cap for elastic capacity (POST /resize "
                        "and /slots/acquire leases); default unbounded")
    p.add_argument("--lease-timeout", type=float, default=None,
                   metavar="SECS",
                   help="auto-release a push-armed slot silent for SECS "
                        "(dead-client reaping; a never-fed --input push "
                        "door stays open until its first client, while "
                        "leases expire even unfed; default: leases "
                        "never expire)")
    p.add_argument("--idle-shrink", type=float, default=None,
                   metavar="SECS",
                   help="auto-shrink trailing slots free for SECS "
                        "(automatic capacity return; default: capacity "
                        "only changes on explicit resize/release)")
    p.add_argument("--mesh", default=None, metavar="DP[xTP]",
                   help="shard the pod over a device mesh: DP devices "
                        "across the stream axis (n inputs must be a "
                        "multiple), optionally xTP devices across the "
                        "flagship's synthesis cells (e.g. 4 or 4x2); "
                        "devices repeat where there are fewer; params "
                        "are shared pod-wide in mesh mode")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host pod: torch.distributed (Gloo) "
                        "rendezvous address, identical on every host "
                        "(with --num-processes/--process-id).  One pod "
                        "spans the hosts: each host runs this command "
                        "with ITS slots' --input list; ingest, WAVs, "
                        "panel and checkpoints stay host-local while the "
                        "hosts tick in lockstep")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="N", help="multi-host pod: total host count")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="multi-host pod: this host's index (0..N-1)")
    p.add_argument("--global-streams", type=int, default=None,
                   help="multi-host pod: TOTAL slot count across hosts "
                        "(default: local --input count x N)")
    p.add_argument("--load-state", default=None, metavar="NPZ",
                   help="resume every slot's DSP carry from a pod "
                        "checkpoint before the first tick")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="checkpoint every slot's DSP carry to NPZ when "
                        "the pod finishes")
    p.add_argument("-o", "--output", default="pod_out",
                   help="output directory (slotN.wav per input)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run to "
                        "DIR")
    _add_config_args(p)
    p.set_defaults(fn=cmd_pod)

    p = sub.add_parser("push",
                       help="feed frames to a remote serving pod over "
                            "HTTP (client for 'pod --serve --input "
                            "push')")
    p.add_argument("--url", required=True, action="append",
                   help="pod panel base URL, e.g. http://host:8000; "
                        "repeat with --slot acquire to place the lease "
                        "across a fleet (most-capacity pod wins)")
    p.add_argument("--slot", default="0",
                   help="target serving slot index (pod panels), or "
                        "'acquire' to lease a slot from the pod "
                        "(POST /slots/acquire — reuses a free slot or "
                        "grows the pod up to its --max-streams)")
    p.add_argument("--stream", action="store_true",
                   help="target a single-stream panel ('stream "
                        "--input push --serve') instead of a pod slot")
    p.add_argument("--input", required=True,
                   help="frame source: raw video file/FIFO, .npy/.npz "
                        "clip, encoded video file, or cv2:N webcam")
    p.add_argument("--size", default=None,
                   help="HxW of incoming frames (raw inputs only)")
    p.add_argument("--pix-fmt", default="rgb24",
                   choices=("rgb24", "i420", "nv12"))
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--realtime", action="store_true",
                   help="pace pushes at --fps (live-camera cadence) "
                        "instead of as fast as the pod accepts them")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--when-empty", default="hold",
                   choices=("hold", "dark"),
                   help="slot policy between pushes: repeat the last "
                        "frame (camera held still) or go dark")
    p.add_argument("--maxsize", type=int, default=8,
                   help="pod-side push queue depth (full queues drop "
                        "their OLDEST frame — newest wins)")
    p.add_argument("--reset", action="store_true",
                   help="zero the slot's DSP state when arming (a "
                        "brand-new client, not the same camera back)")
    p.add_argument("--no-arm", action="store_true",
                   help="skip arming (the slot is already push-armed)")
    p.add_argument("--no-close", action="store_true",
                   help="leave the push stream open when the input ends "
                        "(another push can continue the same slot)")
    p.add_argument("--retries", type=int, default=0,
                   help="re-send after transient failures (connection "
                        "refused/reset, 503) up to N times per request "
                        "— survive a pod restart behind the same "
                        "address")
    p.add_argument("--retry-wait", type=float, default=0.5,
                   metavar="SECS", help="pause between retries")
    p.add_argument("--token",
                   default=os.environ.get("VAUDIO_TOKEN"),
                   help="bearer token for the HTTP panel (also env "
                        "VAUDIO_TOKEN): when set, every endpoint "
                        "requires 'Authorization: Bearer' or '?token='")
    p.set_defaults(fn=cmd_push)

    p = sub.add_parser("pull",
                       help="record/play live audio from a remote "
                            "deployment (client for the audio.wav "
                            "doors of 'pod --serve' / 'stream "
                            "--serve')")
    p.add_argument("--url", required=True,
                   help="panel base URL, e.g. http://host:8000")
    p.add_argument("--slot", type=int, default=0,
                   help="pod serving slot to pull from (default 0)")
    p.add_argument("--stream", action="store_true",
                   help="target a single-stream panel ('stream "
                        "--serve') instead of a pod slot")
    p.add_argument("--seconds", type=float, default=None,
                   help="stop after this much audio (default: until "
                        "the server ends the stream or Ctrl-C)")
    p.add_argument("-o", "--output", default=None, metavar="WAV",
                   help="record to this WAV file")
    p.add_argument("--play", action="store_true",
                   help="play through a local speaker (aplay/pw-play/"
                        "paplay/ffplay or $VAUDIO_PLAYER)")
    p.add_argument("--retries", type=int, default=0,
                   help="retry transient failures (connection refused/"
                        "reset, 503) up to N times when opening the "
                        "stream")
    p.add_argument("--token",
                   default=os.environ.get("VAUDIO_TOKEN"),
                   help="bearer token for the HTTP panel (also env "
                        "VAUDIO_TOKEN): when set, every endpoint "
                        "requires 'Authorization: Bearer' or '?token='")
    p.set_defaults(fn=cmd_pull)

    p = sub.add_parser("debug",
                       help="render the debug surface (heatmaps, hue "
                            "matrix, spectrum, waveform) to PNGs")
    p.add_argument("input",
                   help=".npy/.npz frame or clip tensor, or 'synthetic'")
    p.add_argument("-o", "--output", default="debug_out",
                   help="output directory for the PNG/JSON artifacts")
    p.add_argument("--frames", type=int, default=30,
                   help="synthetic clip length (hue EMA settle time)")
    p.add_argument("--hue", type=float, default=0.33)
    p.add_argument("--saturation", type=float, default=1.0)
    p.add_argument("--brightness", type=float, default=1.0)
    _add_config_args(p)
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("parity",
                       help="verify against the literal reference-math "
                            "oracle")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--size", type=int, default=128)
    p.set_defaults(fn=cmd_parity)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
