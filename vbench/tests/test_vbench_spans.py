"""The readers of the program's spans (``vbench/spans.py`` and the seven
``program_span`` metrics) on hand-made traces."""

import pytest

from vbench import manifest as mf
from vbench import spans as sp
from vbench.trace import WINDOW, Trace

AURALIZER = mf.config(mf.load(), "flagship-1080p")["auralizer"]
LAUNCHER, DRAIN = 1, 2
MS = 1e-3


def _host(tid, name, start_ms, end_ms, cat="user_annotation"):
    return (tid, cat, name, start_ms * MS, (end_ms - start_ms) * MS)


def _trace(host, frames=4):
    """A 100 ms window of 4 frames; thread 1 launches the device work."""
    launches = [_host(LAUNCHER, "cudaLaunchKernel", t, t + 0.01,
                      cat="cuda_runtime") for t in (11, 41, 71)]
    return Trace(window_s=100 * MS,
                 device=[("kernel", "k", t * MS, MS) for t in (12, 42, 72)],
                 host=[_host(0, WINDOW, 0, 100)] + launches + host,
                 frames=frames, auralizer=AURALIZER, height=1080,
                 width=1920)


#: Spans on the launching thread and on a drain thread.  Nested and
#: repeated spans of one name, spans cut by the window's edges, ingest
#: inside the step and on another thread.
SPANS = [
    # ingest on the launcher: 2 + 4 + 2 (clipped at the start) = 8 ms
    _host(LAUNCHER, "vaudio.ingest.frames", -4, 2),
    _host(LAUNCHER, "vaudio.ingest.frames", 5, 9),
    _host(LAUNCHER, "vaudio.ingest.frames", 6, 8),       # nested
    _host(LAUNCHER, "vaudio.ingest.params", 12, 14),     # inside a step
    _host(DRAIN, "vaudio.ingest.frames", 70, 80),        # not the launcher
    # steps on the launcher: 20 + 20 ms, less the 2 ms of params
    _host(LAUNCHER, "vaudio.step", 10, 30),
    _host(LAUNCHER, "vaudio.step", 40, 60),
    _host(LAUNCHER, "vaudio.step", 45, 50),               # nested
    _host(DRAIN, "vaudio.step", 80, 90),                  # not the launcher
    # readbacks on every thread: 5 + 5 (clipped at the end) + 2 = 12 ms
    _host(DRAIN, "vaudio.readback", 20, 25),
    _host(DRAIN, "vaudio.readback", 95, 105),
    _host(LAUNCHER, "vaudio.readback", 20, 22),
    # ticks: one cut by each edge; two wholly inside (30 and 40 ms);
    # three started in the window
    _host(LAUNCHER, "vaudio.pod.tick", -10, 20),
    _host(LAUNCHER, "vaudio.pod.tick", 20, 50),
    _host(LAUNCHER, "vaudio.pod.tick", 50, 90),
    _host(LAUNCHER, "vaudio.pod.tick", 90, 120),
    # stacks: 4 + 6 ms
    _host(LAUNCHER, "vaudio.pod.stack", 25, 29),
    _host(LAUNCHER, "vaudio.pod.stack", 55, 61),
    _host(LAUNCHER, "vaudio.pod.stack", 56, 57),          # nested
    # names that are no reader's
    _host(LAUNCHER, "vaudio.stream.dispatch", 0, 100),
    _host(LAUNCHER, "aten::copy_", 5, 9, cat="cpu_op"),
]

READERS = {
    "ingest_host_ms_per_frame.tput": 8 / 4,
    "ingest_host_ms_per_frame.live": 8 / 4,
    "step_host_ms_per_frame.tput": (40 - 2) / 4,
    "step_host_ms_per_frame.live": (40 - 2) / 4,
    "readback_ms_per_frame.live": 12 / 4,
    "tick_ms.pod": (30 + 40) / 2,
    "stack_ms_per_tick.pod": 10 / 3,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_nested_repeated_and_cut_spans(name):
    assert mf.metric_reader(name)(_trace(SPANS)) == pytest.approx(
        READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_spans_reads_none(name):
    """The parent commit's program records no span: every reader returns
    None, also where other spans of the program are there."""
    others = [s for s in SPANS if not s[2].startswith(
        ("vaudio.ingest", "vaudio.step", "vaudio.readback", "vaudio.pod"))]
    assert mf.metric_reader(name)(_trace(others)) is None
    assert mf.metric_reader(name)(_trace([])) is None


def test_ingest_inside_the_step_is_subtracted():
    steps = [_host(LAUNCHER, "vaudio.step", 10, 30)]
    ingest = [_host(LAUNCHER, "vaudio.ingest.frames", 8, 15),
              _host(LAUNCHER, "vaudio.ingest.params", 20, 22),
              _host(LAUNCHER, "vaudio.ingest.params", 21, 22)]
    assert sp.step_seconds(_trace(steps)) == pytest.approx(20 * MS)
    assert sp.step_seconds(_trace(steps + ingest)) == pytest.approx(
        (20 - 5 - 2) * MS)


def test_ticks_cut_by_the_window_are_left_out():
    read = mf.metric_reader("tick_ms.pod")
    cut = [_host(LAUNCHER, "vaudio.pod.tick", -5, 10),
           _host(LAUNCHER, "vaudio.pod.tick", 95, 101)]
    assert read(_trace(cut)) is None
    assert read(_trace(cut + [_host(LAUNCHER, "vaudio.pod.tick", 10, 22)])
                ) == pytest.approx(12)
    assert len(sp.ticks_started(_trace(cut))) == 1


def test_union_and_overlap():
    u = sp.union([(3, 5), (0, 1), (4, 8), (8, 9), (-2, -1)], 0, 8.5)
    assert u == [(0, 1), (3, 8.5)]
    assert sp.overlap(u, [(0.5, 4), (8, 10)]) == pytest.approx(2.0)
