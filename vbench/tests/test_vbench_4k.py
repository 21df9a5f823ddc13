"""The 4K configuration and its cell ``offline-4k``: the manifest's names,
K1's byte count worked out by hand, the readers of K1's roofline and of
the vision stage's two spans on synthetic traces, the program against the
plain reference under ``flagship-4k``'s groups at a small frame on the
CPU, and the cell's judge on short 4K clips on the card."""

import numpy as np
import pytest

from test_vbench_run import _answer_altered, _half_batch, _state_unchanged
from tiny import TINY
from vbench import manifest as mf
from vbench import pool_counts
from vbench.drive import Cell, Judged, make_pool, program_config
from vbench.judge import judge
from vbench.run import run_cell
from vbench.trace import WINDOW, Trace

CELL = "offline-4k"
CONFIG = mf.config(mf.load(), "flagship-4k")
MS = 1e-3


def test_the_manifest_resolves_the_config_and_the_cell():
    manifest = mf.load()
    entry = mf.workload(manifest, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "flagship-4k", "offline-clips", 1)
    doc = mf.config(manifest, entry["config"])
    assert (doc["frame"]["height"], doc["frame"]["width"]) == (2160, 3840)
    assert doc["auralizer"]["mip_level"] == 3 and doc["reduced"] == []
    assert mf.traffic(entry["traffic"])["entry"] == "sonify"
    assert 0 < mf.limits(CELL)["pcm_gap"] < 1e-3
    e2e = [m["name"] for m in mf.end_to_end(manifest, CELL)]
    assert e2e == ["setup_s", "memory_peak_mb"]
    layer = {m["name"] for m in mf.per_layer(manifest, CELL)}
    assert layer == {"frames_per_s.pretrace", "device_idle_pct.tput",
                     "h2d_ms_per_frame.tput",
                     "floor_mfu_pct.tput", "ingest_host_ms_per_frame.tput",
                     "step_host_ms_per_frame.tput",
                     "k1_roofline_pct.offline4k",
                     "vision_pool_host_ms_per_frame.tput",
                     "vision_stats_host_ms_per_frame.tput"}
    assert "k1_roofline_pct.offline4k" not in {
        m["name"] for m in mf.per_layer(manifest, "offline-1080p")}


def test_k1_bytes_by_hand():
    """Pixels read once and mips written once: 24,883,200 + 1,555,200
    bytes a 4K frame, 6,220,800 + 388,800 at 1080p; 64 4K frames over
    3.35 TB/s take 0.5051 ms."""
    assert pool_counts.k1_bytes(2160, 3840, 3) == 26_438_400
    assert pool_counts.k1_bytes(1080, 1920, 3) == 6_609_600
    assert pool_counts.k1_bound_s(2160, 3840, 3, 64) == pytest.approx(
        0.5051e-3, abs=5e-8)


def _host(tid, name, start_ms, end_ms, cat="user_annotation"):
    return (tid, cat, name, start_ms * MS, (end_ms - start_ms) * MS)


def _trace(host=(), kernels=(), frames=8):
    """A 100 ms 4K window of ``frames`` frames; thread 1 launches the
    device work; ``kernels`` are (name, ms) records on the card."""
    launches = [_host(1, "cudaLaunchKernel", t, t + 0.01,
                      cat="cuda_runtime") for t in (11, 41, 71)]
    device = [("kernel", name, 10 * k * MS, ms * MS)
              for k, (name, ms) in enumerate(kernels)]
    return Trace(window_s=100 * MS, device=device,
                 host=[_host(0, WINDOW, 0, 100)] + launches + list(host),
                 frames=frames, auralizer=CONFIG["auralizer"], height=2160,
                 width=3840)


def _read(name, trace):
    return mf.metric_reader(name)(trace)


#: K1's two launches (one of each entry's names) among other kernels.
KERNELS = [("_anonymous_namespace_::mip_pool_u8_kernel_unsigned_char", 0.4),
           ("mip_pool_yuv420_kernel", 0.2),
           ("hann_peak_weighted_sum_kernel", 3.0),
           ("vectorized_elementwise_kernel", 1.0)]
#: The vision stage's spans on the launcher (nested, repeated and cut by
#: the window's start) and on another thread.
SPANS = [_host(1, "vaudio.step.vision", 5, 60),
         _host(1, "vaudio.vision.pool", -2, 6),          # 6 ms inside
         _host(1, "vaudio.vision.pool", 30, 33),
         _host(1, "vaudio.vision.pool", 31, 32),         # nested
         _host(2, "vaudio.vision.pool", 50, 90),         # not the launcher
         _host(1, "vaudio.vision.stats", 6, 20),
         _host(1, "vaudio.vision.stats", 33, 58),
         _host(2, "vaudio.vision.stats", 0, 100)]


def test_readers():
    tr = _trace(SPANS, KERNELS)
    bound = pool_counts.k1_bound_s(2160, 3840, 3, 8)
    assert _read("k1_roofline_pct.offline4k", tr) == pytest.approx(
        100 * bound / 0.6e-3)
    assert _read("vision_pool_host_ms_per_frame.tput", tr) == \
        pytest.approx((6 + 3) / 8)
    assert _read("vision_stats_host_ms_per_frame.tput", tr) == \
        pytest.approx((14 + 25) / 8)


def test_nothing_to_read():
    """No K1 record, no span of the name (the parent commit records none)
    or no frames: each reader returns None."""
    names = ("k1_roofline_pct.offline4k",
             "vision_pool_host_ms_per_frame.tput",
             "vision_stats_host_ms_per_frame.tput")
    for name in names:
        assert _read(name, _trace()) is None
        assert _read(name, _trace(SPANS, KERNELS, frames=0)) is None
    others = [s for s in SPANS if not s[2].startswith("vaudio.vision")]
    rest = [k for k in KERNELS if "mip_pool" not in k[0]]
    assert _read(names[0], _trace(SPANS, rest)) is None
    for name in names[1:]:
        assert _read(name, _trace(others, KERNELS)) is None


def _small_cell(seconds=1.5, seed=2 ** 31 + 77):
    """``offline-4k`` at 192x256 on the CPU, every group of its
    configuration file as it is but the frame's size."""
    manifest = mf.load()
    entry = mf.workload(manifest, CELL)
    config = mf.config(manifest, entry["config"])
    config["frame"].update(height=192, width=256)
    traffic = mf.traffic(entry["traffic"])
    traffic.update(TINY[entry["traffic"]])
    return Cell(CELL, config, traffic, seed, seconds, False, "cpu",
                None), entry, manifest


def test_program_within_the_cells_limit_on_the_cpu():
    """The chunked path's PCM under ``flagship-4k``'s ``auralizer`` and
    ``live_params`` against the reference: ``correct``, far inside the
    limit."""
    cell, entry, manifest = _small_cell()
    result = run_cell(cell, entry, manifest)
    gap = result["checks"]["pcm_gap"]
    assert result["correct"] is True and result["failed"] == 0, result
    assert gap["value"] < gap["limit"] / 3


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered,
                                   _half_batch],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(monkeypatch, fault):
    from vaudio_torch.runtime import chunked
    monkeypatch.setattr(chunked, "chunk_pipeline",
                        fault(chunked.chunk_pipeline))
    cell, entry, manifest = _small_cell(seconds=1.0)
    result = run_cell(cell, entry, manifest)
    gap = result["checks"]["pcm_gap"]
    assert result["correct"] is False and gap["value"] > gap["limit"]


@pytest.mark.cuda
def test_judge_on_the_card(card):
    """Two 4K clips of 70 frames (a chunk of 64 and a ragged one) through
    ``Auralizer.sonify`` on the card, judged against the reference at the
    published widths: within the cell's limit."""
    from vaudio_torch.api import Auralizer
    manifest = mf.load()
    entry = mf.workload(manifest, CELL)
    cell = Cell(CELL, mf.config(manifest, entry["config"]),
                mf.traffic(entry["traffic"]), 2 ** 31 + 1234, 1.0, False,
                "cuda")
    pool = make_pool(cell, 140)
    cfg, params = program_config(cell.config)
    aur = Auralizer(config=cfg, params=params, device="cuda")
    judged = []
    for first in (0, 70):
        host = pool.on_device(range(first, first + 70)).cpu().numpy()
        pcm = aur.sonify(host)
        judged.append(Judged(f"clip {first}", np.arange(first, first + 70),
                             pcm.reshape(70, cfg.hop_size, -1)))
    gap = judge(cell, pool, judged, mf.limits(CELL))["pcm_gap"]
    assert gap["value"] <= gap["limit"], gap
