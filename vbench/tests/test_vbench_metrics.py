"""The readers' arithmetic on a small synthetic profiler trace."""

import json

import pytest

from vbench import counts
from vbench import manifest as mf
from vbench.trace import WINDOW, read_chrome_trace

AURALIZER = mf.config(mf.load(), "flagship-1080p")["auralizer"]


def _event(cat, name, ts, dur, tid=7, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def _trace(tmp_path, frames=4, drop=()):
    """A 10 ms window (ts 1000-11000 us): kernels and copies busy for 4 ms
    in all, one copy overlapping a kernel, one event outside the window;
    the launching thread 7 in a copy during the longest gap; the kernels
    ``drop`` names (by correlation) lost on the device."""
    events = [
        _event("user_annotation", WINDOW, 1000, 10000, tid=1),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1000, 1000),
        _event("kernel", "hann_peak_weighted_sum_kernel", 2000, 500,
               correlation=1),
        _event("kernel", "hann_peak_weighted_sum_kernel", 2200, 800,
               correlation=2),
        _event("gpu_memset", "Memset (Device)", 6000, 1000),
        _event("kernel", "agc_overlap_add_kernel", 9000, 1000,
               correlation=3),
        _event("kernel", "outside", 20000, 100, correlation=4),
        _event("gpu_user_annotation", WINDOW, 1000, 10000),
        _event("cuda_runtime", "cudaLaunchKernel", 1990, 5, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 2100, 5, correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", 5990, 5, correlation=3),
        _event("cuda_runtime", "cudaLaunchKernel", 19990, 5,
               correlation=4),
        _event("cpu_op", "aten::copy_", 3000, 3000),
        _event("cuda_runtime", "cudaMemcpyAsync", 3500, 2400),
        _event("cpu_op", "aten::add", 7200, 1000),
        _event("cpu_op", "aten::add", 3000, 10, tid=9),
    ]
    events = [e for e in events if e.get("args", {}).get("correlation")
              not in drop or e["cat"] != "kernel"]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path), frames, AURALIZER, 1080, 1920)


def test_window_and_busy(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(0.010)
    assert len(tr.device) == 5
    assert tr.busy_s == pytest.approx(0.004)
    assert [round(g[1], 6) for g in tr.idle_gaps()] == [0.003, 0.002,
                                                        0.001]
    assert tr.launcher() == 7
    assert (tr.launches, tr.lost) == (3, 0) and tr.complete


def test_lost_kernel_records_make_a_trace_incomplete(tmp_path):
    """Launches on the host whose kernels left no device record: past a
    tenth of the window's launches the trace is not complete."""
    tr = _trace(tmp_path, drop=(2,))
    assert (tr.launches, tr.lost) == (3, 1) and not tr.complete
    assert _trace(tmp_path, drop=(4,)).complete     # outside the window


def _read(name, tr):
    return mf.metric_reader(name)(tr)


def test_readers(tmp_path):
    tr = _trace(tmp_path)
    assert _read("device_idle_pct.tput", tr) == pytest.approx(60.0)
    assert _read("device_idle_pct.live", tr) == pytest.approx(60.0)
    assert _read("h2d_ms_per_frame.tput", tr) == pytest.approx(0.25)
    assert _read("h2d_ms_per_frame.live", tr) == pytest.approx(0.25)
    assert _read("device_events_per_frame.live", tr) == pytest.approx(1.25)
    bound = counts.k2_bound_s(AURALIZER, 4, 2)
    assert _read("k2_roofline_pct.offline", tr) == pytest.approx(
        100 * bound / 0.0013)
    floor = counts.step_floor_s(AURALIZER, 1080, 1920)
    assert _read("floor_mfu_pct.tput", tr) == pytest.approx(
        100 * 4 * floor / 0.010)


def test_breakdown(tmp_path):
    b = _trace(tmp_path).breakdown()
    ops = dict(b["device_ops"])
    assert ops["hann_peak_weighted_sum_kernel"] == pytest.approx(0.0013)
    assert "outside" not in ops
    idle = dict(b["idle_gaps"])
    assert idle["cudaMemcpyAsync"] == pytest.approx(0.003)
    assert idle["aten::add"] == pytest.approx(0.002)
    assert sum(idle.values()) == pytest.approx(0.006)


def test_nothing_to_read(tmp_path):
    tr = _trace(tmp_path, frames=0)
    for name in ("h2d_ms_per_frame.tput", "device_events_per_frame.live",
                 "k2_roofline_pct.offline", "floor_mfu_pct.tput"):
        assert _read(name, tr) is None
    tr = _trace(tmp_path)
    tr.device = [d for d in tr.device if "hann_peak" not in d[1]
                 and "HtoD" not in d[1]]
    assert _read("k2_roofline_pct.offline", tr) is None
    assert _read("h2d_ms_per_frame.live", tr) is None


def test_counts_at_1080p():
    """The frozen counts give the program's documented terms at 1080p
    stereo: 1.857 us of frame read and 0.530 us of K2 a frame; a frame's
    floor adds the 16 KiB PCM hop it writes."""
    s = counts.shapes(AURALIZER)
    assert (s["F"], s["NP"], s["K"]) == (2047, 496, 4)
    assert counts.k2_ops(AURALIZER, 1) / counts.F32_OPS_PER_S \
        == pytest.approx(0.530e-6, rel=2e-3)
    assert 1080 * 1920 * 3 / counts.HBM_BYTES_PER_S == pytest.approx(
        1.857e-6, rel=2e-3)
    assert counts.step_bytes(AURALIZER, 1080, 1920) == 1080 * 1920 * 3 \
        + 4 * 2 * 2048
    assert counts.step_floor_s(AURALIZER, 1080, 1920) == pytest.approx(
        counts.step_bytes(AURALIZER, 1080, 1920) / counts.HBM_BYTES_PER_S)
    assert counts.step_ops(AURALIZER, 1080, 1920) \
        < counts.step_bytes(AURALIZER, 1080, 1920) \
        * counts.F32_OPS_PER_S / counts.HBM_BYTES_PER_S
