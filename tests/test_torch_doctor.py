"""The port's ``doctor`` (vaudio_torch.utils.doctor) on the CPU: the
counterparts of tests/test_doctor.py with ``--platform cpu``, the kernel
build check that takes the compile cache's place, and the panel probe of
the port's pods (with a token) and of the JAX package's.

The property the JAX doctor's tests hold stays: every probe that touches
the device is watchdogged — a hung device yields a fail verdict, never a
hang — and without a card the default (the card) fails loudly."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import vaudio_torch.utils.doctor as doc
from vaudio.config import AuralizerConfig as JaxConfig
from vaudio.runtime import MultiStreamAuralizer as JaxPod
from vaudio.utils.doctor import format_report as jax_format_report
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.ops import _build
from vaudio_torch.runtime import MultiStreamAuralizer
from vaudio_torch.runtime.engine import AuralizerEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_pod(n_streams=1):
    eng = AuralizerEngine(AuralizerConfig(), device="cpu")
    return MultiStreamAuralizer(eng.cfg, n_streams=n_streams, engine=eng,
                                exit_when_exhausted=False)


class TestChecks:
    def test_versions_name_torch_and_the_port(self):
        c = doc.check_versions()
        assert c["status"] == "ok"
        assert "vaudio_torch 0.1.0" in c["detail"]
        assert "torch " in c["detail"] and "jax" not in c["detail"]

    def test_backend_cpu_ok(self):
        c = doc.check_backend(platform="cpu", timeout=120)
        assert c["status"] == "ok", c
        assert c["detail"].startswith("cpu (1 device(s)")

    def test_backend_without_a_card_fails(self):
        """The default probe is the card; this machine has none."""
        c = doc.check_backend(timeout=120)
        assert c["status"] == "fail"
        assert "torch.cuda.is_available() is False" in c["detail"]

    def test_backend_watchdog_kills_hung_probe(self, monkeypatch):
        """A hung device init yields a fail verdict within the watchdog
        budget, not a hung doctor."""
        real_run = subprocess.run

        def hang(cmd, **kw):
            return real_run([sys.executable, "-c",
                             "import time; time.sleep(3600)"], **kw)
        monkeypatch.setattr(doc.subprocess, "run", hang)
        t0 = time.monotonic()
        c = doc.check_backend(platform="cpu", timeout=1.5)
        assert time.monotonic() - t0 < 30
        assert c["status"] == "fail"
        assert "exceeded 2s" in c["detail"] and "unreachable" in c["detail"]

    def test_kernels_without_nvcc(self):
        """No nvcc here: a warn on the CPU (the plain versions run), a fail
        for the card."""
        c = doc.check_kernels(platform="cpu")
        assert c["status"] == "warn" and "nvcc not found" in c["detail"]
        assert "writable" in c["detail"]
        c = doc.check_kernels()
        assert c["status"] == "fail" and "nvcc not found" in c["detail"]

    def test_kernels_build_dir_unwritable_fails(self, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_ROOT",
                            _build.Path("/proc/definitely/not/writable"))
        c = doc.check_kernels(platform="cpu")
        assert c["status"] == "fail" and "not writable" in c["detail"]

    def test_kernels_build_on_the_card_in_a_watchdogged_probe(
            self, monkeypatch, tmp_path):
        """With an nvcc and a card, the kernel library builds and loads in
        a subprocess under the watchdog: a hung build fails the check."""
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\nexit 0\n")
        fake.chmod(0o755)
        monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                                   f"{os.environ['PATH']}")
        real_run = subprocess.run

        def hang(cmd, **kw):
            return real_run([sys.executable, "-c",
                             "import time; time.sleep(3600)"], **kw)
        monkeypatch.setattr(doc.subprocess, "run", hang)
        c = doc.check_kernels(timeout=1.5)
        assert c["status"] == "fail"
        assert c["detail"] == "kernel build/load exceeded 2s"

    def test_native_loads(self):
        c = doc.check_native()
        assert c["status"] == "ok", c
        assert "libvaudio_torch_rt.so" in c["detail"]

    def test_player_found_via_override(self, tmp_path, monkeypatch):
        fake = tmp_path / "fakeplay"
        fake.write_text("#!/bin/sh\ncat > /dev/null\n")
        fake.chmod(0o755)
        monkeypatch.setenv("VAUDIO_PLAYER", str(fake))
        monkeypatch.setenv("PATH",
                           f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
        c = doc.check_player()
        assert c["status"] == "ok" and "fakeplay" in c["detail"]

    def test_player_missing_is_warn_not_fail(self, monkeypatch):
        monkeypatch.delenv("VAUDIO_PLAYER", raising=False)
        monkeypatch.setenv("PATH", "/nonexistent")
        assert doc.check_player()["status"] == "warn"

    def test_decode_backends(self, monkeypatch):
        assert doc.check_decode()["status"] in ("ok", "warn")
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setenv("PATH", "/nonexistent")
        c = doc.check_decode()
        assert c["status"] == "warn" and "no encoded-video" in c["detail"]

    def test_smoke_cpu(self):
        c = doc.check_smoke(platform="cpu", timeout=300)
        assert c["status"] == "ok", c
        assert c["detail"].startswith("PCM (4096,)")
        assert c["detail"].endswith("(cpu)")

    def test_smoke_defaults_to_the_card(self):
        c = doc.check_smoke(timeout=300)
        assert c["status"] == "fail"
        assert "torch.cuda.is_available() is False" in c["detail"]

    def test_platform_is_checked(self):
        with pytest.raises(ValueError, match="platform"):
            doc.check_smoke(platform="tpu")

    def test_format_report_counts(self):
        checks = [{"name": "a", "status": "ok", "detail": "x"},
                  {"name": "bb", "status": "warn", "detail": "y"},
                  {"name": "c", "status": "fail", "detail": "z"}]
        text = doc.format_report(checks)
        assert "1 failed" in text and "1 warning" in text
        assert "[FAIL] c" in text
        assert text == jax_format_report(checks)


class TestPanelCheck:
    def test_pod_panel_ok_warn_fail(self):
        """check_panel against the port's pod panel: ok while serving,
        warn with a failed slot, fail once stopped."""
        pod = cpu_pod(2)
        server = pod.serve(port=0)
        try:
            frame = np.zeros((64, 64, 3), np.uint8)

            def bad():
                yield frame
                raise OSError("camera unplugged")
            pod.start([iter([frame.copy()] * 2), bad()])
            t0 = time.monotonic()
            while pod.slot_errors[1] is None:
                pod.raise_if_failed()
                assert time.monotonic() - t0 < 120
                time.sleep(0.01)
            c = doc.check_panel(server.url)
            assert c["status"] == "warn", c
            assert "1 failed [1]" in c["detail"]
            pod.slot_errors[1] = None
            assert doc.check_panel(server.url)["status"] == "ok"
            pod.stop()
            c = doc.check_panel(server.url)
            assert c["status"] == "fail" and "STOPPED" in c["detail"]
        finally:
            server.stop()
            pod.stop()

    def test_panel_token(self):
        pod = cpu_pod()
        server = pod.serve(port=0, token="dockey")
        try:
            pod.start([iter(())])
            assert doc.check_panel(server.url)["status"] == "fail"
            c = doc.check_panel(server.url, token="dockey")
            assert c["status"] == "ok", c
        finally:
            server.stop()
            pod.stop()

    def test_unreachable_panel_fails(self):
        c = doc.check_panel("http://127.0.0.1:1", timeout=3)
        assert c["status"] == "fail" and "unreachable" in c["detail"]

    def test_fleet_urls_one_row_per_pod(self):
        """run_doctor(url=[...]): one labelled row per pod — the port's and
        the JAX package's panels alike — dead pods failing without hiding
        the live ones."""
        pod = cpu_pod()
        server = pod.serve(port=0)
        jax_pod = JaxPod(JaxConfig(), n_streams=1, exit_when_exhausted=False,
                         prefer_native=False)
        jax_server = jax_pod.serve(port=0)
        try:
            pod.start([iter(())])
            jax_pod.start([iter(())])
            checks = doc.run_doctor(
                skip_backend=True, skip_smoke=True, platform="cpu",
                url=[server.url, jax_server.url, "http://127.0.0.1:1"])
            rows = {c["name"]: c for c in checks
                    if c["name"].startswith("panel")}
            assert set(rows) == {"panel[0]", "panel[1]", "panel[2]"}
            assert rows["panel[0]"]["status"] == "ok"
            assert rows["panel[1]"]["status"] == "ok"
            assert rows["panel[2]"]["status"] == "fail"
            assert server.url.rstrip("/") in rows["panel[0]"]["detail"]
        finally:
            for srv, p in ((server, pod), (jax_server, jax_pod)):
                srv.stop()
                p.stop()

    def test_stream_panel_shape(self):
        aur = Auralizer(source=np.zeros((3, 64, 64, 3), np.float32),
                        device="cpu")
        aur.start()
        server = aur.serve(port=0)
        try:
            c = doc.check_panel(server.url)
            assert c["status"] == "ok" and "stream:" in c["detail"]
        finally:
            server.stop()
            aur.stop()


class TestDoctorCLI:
    def test_cli_json_and_exit_code(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        proc = subprocess.run(
            [sys.executable, "-m", "vaudio_torch", "doctor", "--platform",
             "cpu", "--skip-smoke", "--json"],
            capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        checks = json.loads(proc.stdout)
        names = {c["name"] for c in checks}
        assert {"versions", "backend", "kernels", "native", "decode",
                "player"} == names
        assert all(c["status"] != "fail" for c in checks)

    def test_cli_fails_without_a_card(self, monkeypatch, capsys):
        """In process: the default platform is the card, so ``doctor``
        exits 1 here and names what failed."""
        from vaudio_torch import cli
        monkeypatch.delenv("VAUDIO_PLATFORM", raising=False)
        assert cli.main(["doctor", "--skip-smoke", "--skip-backend"]) == 1
        out = capsys.readouterr().out
        assert "[FAIL] kernels" in out and "1 failed" in out
        monkeypatch.setenv("VAUDIO_PLATFORM", "cpu")
        assert cli.main(["doctor", "--skip-smoke", "--skip-backend"]) == 0

    def test_run_doctor_skips(self):
        checks = doc.run_doctor(skip_backend=True, skip_smoke=True,
                                platform="cpu")
        names = [c["name"] for c in checks]
        assert "backend" not in names and "smoke" not in names
        assert names[:2] == ["versions", "kernels"]
