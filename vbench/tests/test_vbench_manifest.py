"""BENCHMARK.json against the contract's form, every name resolving to its
file, and a new configuration, traffic mix, cell and metric found from new
files and entries alone."""

import json
import re
import shutil

import pytest

from vbench import manifest as mf
from vbench.run import main as run_main

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def manifest():
    return mf.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_form(manifest):
    assert set(manifest) == TOP
    assert (mf.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(manifest["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51
    for section, keys in KEYS.items():
        names = [e["name"] for e in manifest[section]]
        assert len(names) == len(set(names))
        for e in manifest[section]:
            assert keys <= set(e) <= keys | {"workloads"}, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)


def test_bounds_and_sources(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}


def test_cells(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        e2e = {m["name"] for m in mf.end_to_end(manifest, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = mf.per_layer(manifest, w["name"])
        assert layer, w["name"]
        assert all(m["moves"] in e2e for m in layer)
    assert len(pairs) == len(manifest["workloads"])
    used = {w["config"] for w in manifest["workloads"]}
    assert used == configs


def test_names_resolve(manifest):
    files = set()
    for c in manifest["configs"]:
        assert c["file"].startswith("vbench/") and c["file"] not in files
        files.add(c["file"])
        doc = mf.config(manifest, c["name"])
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"] == []
        assert (mf.HERE / "reference" / f"{doc['reference']}.py").exists()
    for w in manifest["workloads"]:
        t = mf.traffic(w["traffic"])
        assert t["entry"] in ("sonify", "stream", "pod")
        assert t["phase_sum"] in ("frame", "advances")
        assert mf.limits(w["name"])["pcm_gap"] > 0
    for m in manifest["per_layer"]:
        assert callable(mf.metric_reader(m["name"]))
        for cell in m.get("workloads", []):
            mf.workload(manifest, cell)


def test_configs_fix_semantics_only(manifest):
    """A configuration fixes what is computed; the kernel switches stay at
    the program's defaults."""
    from vaudio_torch.config import AuralizerConfig
    switches = {"use_pallas", "use_pallas_audio", "use_pallas_pool",
                "use_pallas_vision", "use_matmul_irfft", "use_matmul_ema",
                "use_cumsum_phases", "use_phase_lut"}
    for c in manifest["configs"]:
        doc = mf.config(manifest, c["name"])
        assert not switches & set(doc["auralizer"])
        AuralizerConfig(**doc["auralizer"])


def test_new_files_are_found_without_edits(tmp_path, manifest):
    """A copy that gains a configuration, a traffic mix, a cell with its
    limits and a per-layer metric: every new name resolves, and no file
    that was there changed but BENCHMARK.json's new entries."""
    shutil.copytree(mf.HERE, tmp_path / "vbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "vbench").rglob("*")
              if p.is_file()}
    new = json.loads(json.dumps(manifest))
    doc = mf.config(manifest, "flagship-1080p")
    doc.update(name="flagship-720p", frame=dict(doc["frame"], height=720,
                                                width=1280))
    (tmp_path / "vbench/configs/flagship-720p.json").write_text(
        json.dumps(doc))
    traffic = mf.traffic("live-30fps")
    traffic["fps"] = 60.0
    (tmp_path / "vbench/traffic/live-60fps.json").write_text(
        json.dumps(traffic))
    (tmp_path / "vbench/limits/live-720p-60fps.json").write_text(
        json.dumps({"pcm_gap": 1e-4}))
    (tmp_path / "vbench/metrics/window_s.live.py").write_text(
        "def read(trace):\n    return trace.window_s\n")
    new["configs"].append(dict(name="flagship-720p", source="x",
                               file="vbench/configs/flagship-720p.json",
                               reduced=[], why="x"))
    new["workloads"].append(dict(name="live-720p-60fps",
                                 config="flagship-720p",
                                 traffic="live-60fps", chips=1, why="x"))
    new["per_layer"].append(dict(name="window_s.live", unit="s",
                                 better="lower", source="device_trace",
                                 layer="device", moves="latency_p95_ms",
                                 workloads=["live-720p-60fps"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    m = mf.load(tmp_path)
    entry = mf.workload(m, "live-720p-60fps")
    assert mf.config(m, entry["config"], tmp_path)["frame"]["height"] == 720
    assert mf.traffic(entry["traffic"], tmp_path)["fps"] == 60.0
    assert mf.limits("live-720p-60fps", tmp_path)["pcm_gap"] == 1e-4
    names = [x["name"] for x in mf.per_layer(m, "live-720p-60fps")]
    assert names == ["window_s.live"]

    class T:
        window_s = 2.5
    assert mf.metric_reader("window_s.live", tmp_path)(T) == 2.5
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_no_card_no_result(capsys):
    """Without a card the run exits non-zero and prints no result: it does
    not fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run_main(["--workload", "offline-1080p", "--seed", "3",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
