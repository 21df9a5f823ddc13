"""A whole run of each cell's driver at a tiny size on the CPU (the look
for a card skipped): the result line's keys, and ``correct`` false when
the timed path is broken underneath."""

import json

import pytest
import torch

from tiny import tiny_cell
from vbench.run import forbidden_modules, program_origin, run_cell

CELLS = ["offline-1080p", "live-1080p-30fps", "pod-1080p-s8"]


def test_result_line(capsys):
    for name in CELLS:
        cell, entry, manifest = tiny_cell(name)
        result = run_cell(cell, entry, manifest)
        line = json.loads(json.dumps(result))
        assert list(line) == ["correct", "attempted", "failed", "metrics",
                              "device", "checks"], name
        assert line["correct"] is True, (name, line)
        assert line["attempted"] > 0 and line["failed"] == 0
        assert {"platform", "count", "memory_peak_bytes"} <= set(
            line["device"])
        reported = set(line["metrics"])
        assert "setup_s" in reported and len(reported) >= 2, name
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]
        gap = line["checks"]["pcm_gap"]
        assert gap["value"] <= gap["limit"]


def test_forbidden_names_compare_whole(monkeypatch):
    assert "vaudio" not in forbidden_modules()      # vaudio_torch is loaded
    monkeypatch.setitem(__import__("sys").modules, "vaudio.x", object())
    assert forbidden_modules() == ["vaudio"]


def test_program_comes_from_the_checkout(tmp_path):
    """In a directory with only the benchmark's files there is no program
    to measure: a copy imported from elsewhere does not count."""
    assert program_origin() is None
    assert program_origin(tmp_path) is not None


def _state_unchanged(orig):
    def step(carry, *args, **kwargs):
        _new, out = orig(carry, *args, **kwargs)
        return carry, out
    return step


def _answer_altered(orig):
    def step(*args, **kwargs):
        carry, out = orig(*args, **kwargs)
        pcm = out["pcm"].contiguous().clone()
        pcm.view(-1)[7] += 0.01
        return carry, dict(out, pcm=pcm)
    return step


def _half_batch(orig):
    """The second half of the batch (a pod's streams, a chunk's frames)
    left out: its frames go in black."""
    def step(carry, frames, *args, **kwargs):
        frames = frames.clone()
        frames[frames.shape[0] // 2:] = 0
        return orig(carry, frames, *args, **kwargs)
    return step


#: Where each cell's timed path produces its state and answers.
STEP = {"offline-1080p": "vaudio_torch.runtime.chunked.chunk_pipeline",
        "live-1080p-30fps": "vaudio_torch.runtime.step.frame_step",
        "pod-1080p-s8": "vaudio_torch.runtime.step.frame_step"}
FAULTS = [(c, f) for c in CELLS
          for f in (_state_unchanged, _answer_altered, _half_batch)
          if not (c.startswith("live") and f is _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    module, attr = STEP[name].rsplit(".", 1)
    mod = __import__(module, fromlist=[attr])
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    cell, entry, manifest = tiny_cell(name, seconds=1.0)
    result = run_cell(cell, entry, manifest)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["pcm_gap"]["value"] > \
        result["checks"]["pcm_gap"]["limit"]
    torch.set_num_threads(torch.get_num_threads())
