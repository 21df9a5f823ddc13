"""Environment health checks — the ``doctor`` command of the port's CLI,
the counterpart of :mod:`vaudio.utils.doctor`.

A deployment's failure modes are CHECKED before serving, not discovered
mid-stream: is the card reachable, do the CUDA kernels build and load, does
the native runtime library build, which decode backends and audio sinks
exist, and does a frame actually sonify end to end.

Design rules (the JAX doctor's):

* **Every probe that touches the device is time-bounded**: it runs in a
  watchdogged SUBPROCESS, so the doctor itself never creates a CUDA
  context and never hangs.
* **Three verdicts**: ``ok`` (healthy), ``warn`` (an optional capability
  is missing — raw serving still works), ``fail`` (a required capability
  is broken).  The CLI exits 1 only on ``fail``.

Where the JAX doctor checks its persistent compile cache, this one checks
the kernels' build directory (:func:`check_kernels`): eager PyTorch
compiles nothing, and the kernels are built once per source hash into
``build/vaudio_torch/``.  ``platform`` is ``None`` or ``"cuda"`` (the
card) or ``"cpu"``.

Each check returns ``{"name", "status", "detail"}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

Check = Dict[str, str]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _result(name: str, status: str, detail: str) -> Check:
    return {"name": name, "status": status, "detail": detail}


def _on_card(platform: Optional[str]) -> bool:
    if platform not in (None, "cuda", "cpu"):
        raise ValueError(f"platform must be None, 'cuda' or 'cpu', got "
                         f"{platform!r}")
    return platform != "cpu"


def check_versions() -> Check:
    """Interpreter / library versions (never fails — context for the
    rest of the report)."""
    import numpy as np
    import torch

    import vaudio_torch
    detail = (f"python {sys.version.split()[0]}, "
              f"vaudio_torch {vaudio_torch.__version__}, "
              f"torch {torch.__version__}, cuda {torch.version.cuda}, "
              f"numpy {np.__version__}")
    return _result("versions", "ok", detail)


def _subprocess_env() -> dict:
    """Child env for probes: inherit everything and make the repository
    importable."""
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _REPO not in parts:
        env["PYTHONPATH"] = os.pathsep.join([_REPO] + parts)
    return env


def _probe(code: str, timeout: float):
    """Run ``code`` in a fresh interpreter under a watchdog: (the last
    stdout line, None) on success, else (None, why it failed)."""
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, env=_subprocess_env())
    except subprocess.TimeoutExpired:
        return None, f"exceeded {timeout:.0f}s"
    if proc.returncode != 0:
        tail = " ".join((proc.stderr or "").strip().splitlines()[-1:])
        return None, f"failed: {tail or 'no stderr'}"
    return proc.stdout.strip().splitlines()[-1], None


def check_backend(platform: Optional[str] = None,
                  timeout: float = 90.0) -> Check:
    """Probe the device in a watchdogged subprocess: on the card, CUDA's
    device count and name and one synchronised allocation (the CUDA
    context); ``platform="cpu"`` only checks that torch runs.  A missing
    card fails unless the CPU was asked for."""
    code = (
        "import json\n"
        "import torch\n"
        + ("print(json.dumps({'platform': 'cpu', 'n': 1,"
           " 'kind': 'cpu'}))\n" if not _on_card(platform) else
           "if not torch.cuda.is_available():\n"
           "    raise SystemExit('torch.cuda.is_available() is False: no "
           "card (CPU: --platform cpu)')\n"
           "torch.zeros(1, device='cuda')\n"
           "torch.cuda.synchronize()\n"
           "print(json.dumps({'platform': 'cuda',"
           " 'n': torch.cuda.device_count(),"
           " 'kind': torch.cuda.get_device_name(0)}))\n"))
    line, why = _probe(code, timeout)
    if why is not None:
        return _result(
            "backend", "fail",
            f"device init {why}" + (" — the card is missing or "
                                    "unreachable (CPU: --platform cpu)"
                                    if why.startswith("exceeded") else ""))
    info = json.loads(line)
    return _result(
        "backend", "ok",
        f"{info['platform']} ({info['n']} device(s), {info['kind']})")


def check_kernels(platform: Optional[str] = None,
                  timeout: float = 300.0) -> Check:
    """The CUDA kernels' build: the build directory must be writable and
    ``nvcc`` found; on the card, the kernel library (the four kernels of
    ``vaudio_torch/csrc``) must build and load, in a watchdogged
    subprocess.  Without the card (``platform="cpu"``) a missing ``nvcc``
    is a warn: the CPU runs each kernel's plain version."""
    from vaudio_torch.ops import _build
    root = str(_build.BUILD_ROOT)
    try:
        os.makedirs(root, exist_ok=True)
        probe = os.path.join(root, ".doctor_probe")
        with open(probe, "w") as fh:
            fh.write("ok")
        os.remove(probe)
    except OSError as e:
        return _result("kernels", "fail", f"{root} not writable: {e}")
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        if not _on_card(platform):
            return _result("kernels", "warn",
                           f"{e}; the CPU runs the plain versions ({root} "
                           "writable)")
        return _result("kernels", "fail", str(e))
    if not _on_card(platform):
        return _result("kernels", "ok",
                       f"{root} writable, {nvcc} found (not built: cpu)")
    code = ("from vaudio_torch.ops import _build\n"
            "path = _build.build()\n"
            "_build.lib()\n"
            "print(path)\n")
    line, why = _probe(code, timeout)
    if why is not None:
        return _result("kernels", "fail", f"kernel build/load {why}")
    n = len(list(_build.CSRC.glob("*.cu")))
    return _result("kernels", "ok",
                   f"{n} CUDA sources built by {nvcc} and loaded: {line}")


def check_native() -> Check:
    """Build (if needed) and load the native runtime library
    (native/ringbuffer.cpp + framereader.cpp).  Optional: the Python
    ring-buffer twin is functionally identical, so a missing toolchain
    is a warn, not a fail."""
    from vaudio_torch.runtime.ringbuffer import _load_native, library_path
    lib = _load_native()
    if lib is None:
        return _result(
            "native", "warn",
            f"{library_path()} failed to build/load (g++ missing?) — "
            "Python ring-buffer fallback in use (functional, slower "
            "ingest overlap)")
    return _result("native", "ok", f"{library_path()} loaded")


def check_decode() -> Check:
    """Encoded-video decode backends (io.VideoFileSource): cv2 and/or
    an ffmpeg binary.  Raw rgb24/i420/nv12 ingest needs neither."""
    found = []
    try:
        import cv2
        found.append(f"cv2 {cv2.__version__}")
    except Exception:
        pass
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        found.append(ffmpeg)
    if not found:
        return _result(
            "decode", "warn",
            "no encoded-video backend (cv2 import failed, no ffmpeg on "
            "PATH): mp4/avi/mkv inputs unavailable; raw rgb24/i420/"
            "nv12 and .npy ingest unaffected")
    return _result("decode", "ok", ", ".join(found))


def check_player() -> Check:
    """Audio playback sink for ``stream --play``
    (io.SubprocessPlayer: $VAUDIO_PLAYER or aplay/pw-play/paplay/
    ffplay)."""
    override = os.environ.get("VAUDIO_PLAYER")
    if override:
        exe = shutil.which(override.split()[0])
        if exe:
            return _result("player", "ok", f"$VAUDIO_PLAYER -> {exe}")
        return _result("player", "warn",
                       f"$VAUDIO_PLAYER={override!r} not on PATH")
    for cand in ("aplay", "pw-play", "paplay", "ffplay"):
        exe = shutil.which(cand)
        if exe:
            return _result("player", "ok", exe)
    return _result(
        "player", "warn",
        "no audio player on PATH (aplay/pw-play/paplay/ffplay): "
        "stream --play unavailable; WAV/stdout sinks unaffected")


def check_smoke(platform: Optional[str] = "cuda",
                timeout: float = 300.0) -> Check:
    """End-to-end smoke in a watchdogged subprocess: two solid-colour u8
    frames through the full pipeline (``Auralizer.sonify``), asserting
    finite, non-trivial PCM.  It runs on the card by default — in the port
    the card is what must be checked — or on the CPU with
    ``platform="cpu"``."""
    device = None if _on_card(platform) else "cpu"
    code = (
        "import numpy as np\n"
        "from vaudio_torch.api import Auralizer\n"
        "frames = np.tile(np.array([220, 40, 30], np.uint8),"
        " (2, 64, 64, 1))\n"
        f"pcm = np.asarray(Auralizer(device={device!r}).sonify(frames))\n"
        "assert pcm.size and np.isfinite(pcm).all(), pcm.shape\n"
        "print('PCM', pcm.shape, float(np.abs(pcm).max()))\n")
    line, why = _probe(code, timeout)
    if why is not None:
        return _result("smoke", "fail", f"end-to-end sonify {why}")
    return _result("smoke", "ok",
                   f"{line} ({'cuda' if _on_card(platform) else 'cpu'})")


def check_panel(url: str, timeout: float = 10.0,
                token: Optional[str] = None) -> Check:
    """Health of a RUNNING deployment over its HTTP panel (``stream
    --serve`` or ``pod --serve``): GET /metrics and judge the serving
    state.  A pod with failed slots is a ``warn`` (failures are
    slot-isolated; re-arm them); an unreachable panel or a stopped pod is
    a ``fail``."""
    import urllib.request
    base = url if "://" in url else f"http://{url}"
    base = base.rstrip("/")
    req = urllib.request.Request(
        base + "/metrics",
        headers=({"Authorization": f"Bearer {token}"} if token else {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            m = json.loads(r.read())
    except (OSError, ValueError) as e:
        return _result("panel", "fail",
                       f"{base}/metrics unreachable or invalid: {e}")
    if "slots" in m:                               # pod panel
        slots = m.get("slots", [])
        failed = [i for i, s in enumerate(slots) if s.get("failed")]
        active = sum(1 for s in slots if s.get("active"))
        p50 = m.get("dispatch_latency_p50_ms")
        detail = (f"pod {'running' if m.get('running') else 'STOPPED'}"
                  f": {m.get('n_streams')} slot(s), {active} active, "
                  f"{len(failed)} failed"
                  + (f" {failed}" if failed else "")
                  + f", {m.get('frames_processed', 0)} frames"
                  + (f", p50 dispatch {p50:.1f} ms"
                     if isinstance(p50, (int, float)) else ""))
        if not m.get("running"):
            return _result("panel", "fail", detail)
        return _result("panel", "warn" if failed else "ok", detail)
    p50 = m.get("total_latency_p50_ms")
    detail = (f"stream: {m.get('frames_processed', 0)} frames, "
              f"buffer fill {m.get('buffer_fill')}, "
              f"{m.get('dropped_frames', 0)} dropped"
              + (f", p50 total latency {p50:.1f} ms"
                 if isinstance(p50, (int, float)) else ""))
    return _result("panel", "ok", detail)


def run_doctor(platform: Optional[str] = None, timeout: float = 90.0,
               skip_backend: bool = False, skip_smoke: bool = False,
               smoke_timeout: float = 300.0,
               url=None,
               token: Optional[str] = None) -> List[Check]:
    """Run every check; see the module docstring for the verdict model.
    With ``url`` (one base URL or a list — a fleet), also probe each
    RUNNING deployment's HTTP panel (:func:`check_panel`)."""
    checks = [check_versions()]
    if not skip_backend:
        checks.append(check_backend(platform, timeout))
    checks.extend([check_kernels(platform, smoke_timeout), check_native(),
                   check_decode(), check_player()])
    if not skip_smoke:
        checks.append(check_smoke(platform, smoke_timeout))
    if url:
        urls = [url] if isinstance(url, str) else list(url)
        for i, u in enumerate(urls):
            c = check_panel(u, token=token)
            if len(urls) > 1:      # fleet probe: name each pod's row
                c["name"] = f"panel[{i}]"
                if u.rstrip("/") not in c["detail"]:
                    # failure details already name the URL
                    c["detail"] = f"{u}: {c['detail']}"
            checks.append(c)
    return checks


def format_report(checks: List[Check]) -> str:
    mark = {"ok": " ok ", "warn": "warn", "fail": "FAIL"}
    width = max(len(c["name"]) for c in checks)
    lines = [f"[{mark[c['status']]}] {c['name']:<{width}}  {c['detail']}"
             for c in checks]
    bad = sum(c["status"] == "fail" for c in checks)
    warn = sum(c["status"] == "warn" for c in checks)
    lines.append(f"doctor: {len(checks)} checks, {bad} failed, "
                 f"{warn} warning(s)")
    return "\n".join(lines)
