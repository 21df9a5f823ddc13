"""A configuration file names its model family: each of the three entries
builds the family the file names (the flagship where it names none), and
refuses, before any frame, a program that would run another configuration
than the file states."""

import copy

import pytest

from tiny import tiny_cell
from vbench import drive
from vbench.drive import DRIVERS, make_pool, pool_frames

#: A cell of each entry, by entry.
ENTRY_CELL = {"sonify": "offline-1080p", "stream": "live-1080p-30fps",
              "pod": "pod-1080p-s8"}
FLAGSHIP_CELLS = ["offline-1080p", "live-1080p-30fps", "pod-1080p-s8",
                  "offline-4k"]


class _Built(Exception):
    """Stops a driver once its program is built and checked."""


def _family_cell(entry: str, model: str, channels: int = 1):
    """The tiny cell of ``entry`` under a copy of ``flagship-1080p`` that
    names ``model`` and ``channels``."""
    cell, _entry, _manifest = tiny_cell(ENTRY_CELL[entry], seconds=1.0)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"] = model
    cell.config["auralizer"]["channels"] = channels
    return cell


def _drive(cell):
    pool = make_pool(cell, pool_frames(cell))
    return DRIVERS[cell.traffic["entry"]](cell, pool, pool.to_host())


@pytest.fixture
def chunk_steps(monkeypatch):
    """Counts the calls of ``OrthoModesModel.chunk_step``, through which
    every entry's frames reach the OrthoModes model."""
    from vaudio_torch.models.orthomodes import OrthoModesModel
    calls = []
    orig = OrthoModesModel.chunk_step

    def chunk_step(self, *args, **kwargs):
        calls.append(1)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(OrthoModesModel, "chunk_step", chunk_step)
    return calls


@pytest.mark.parametrize("name", FLAGSHIP_CELLS)
def test_flagship_cells_build_what_they_built(monkeypatch, name):
    """A file with no ``model`` key builds the flagship with the arguments
    the entries gave before the family was a field: ``Auralizer(config,
    params, device)`` (``realtime=False`` live) and the pod's
    ``AuralizerEngine(cfg, debug=False, device)``."""
    from vaudio_torch import api
    from vaudio_torch.runtime import engine as engine_mod
    from vaudio_torch.runtime.engine import AuralizerEngine
    cell, _entry, _manifest = tiny_cell(name)
    assert "model" not in cell.config
    cfg, params = drive.program_config(cell.config)
    inits, engines = [], []
    orig_init, orig_make = api.Auralizer.__init__, engine_mod.make_engine

    def init(self, *args, **kwargs):
        inits.append((args, kwargs))
        orig_init(self, *args, **kwargs)

    def make_engine(*args, **kwargs):
        built = orig_make(*args, **kwargs)
        engines.append((args, kwargs, built))
        return built

    def check_runs(*args):
        orig_check(*args)
        raise _Built

    orig_check = drive.check_runs
    monkeypatch.setattr(api.Auralizer, "__init__", init)
    monkeypatch.setattr(api, "make_engine", make_engine)
    monkeypatch.setattr(engine_mod, "make_engine", make_engine)
    monkeypatch.setattr(drive, "check_runs", check_runs)
    with pytest.raises(_Built):
        _drive(cell)
    entry = cell.traffic["entry"]
    if entry == "pod":
        assert inits == []
        [(args, kwargs, built)] = engines
        assert (args, kwargs) == (("auralizer", cfg), {"device": "cpu"})
    else:
        [(args, kwargs)] = inits
        want = dict(config=cfg, params=params, model="auralizer",
                    device="cpu")
        if entry == "stream":
            want["realtime"] = False
        assert args == () and kwargs == want
        [(_args, engine_kwargs, built)] = engines
        assert engine_kwargs["debug"] is True      # the API's default
    assert type(built) is AuralizerEngine and built.cfg == cfg
    assert built.debug is (entry != "pod")


@pytest.mark.parametrize("entry", sorted(ENTRY_CELL))
def test_orthomodes_file_drives_orthomodes(chunk_steps, entry):
    """``"model": "orthomodes"`` with one channel: every entry reaches the
    per-pixel model (160x320 at its mip 5: 50 oscillators) and produces
    mono hops, none failed."""
    cell = _family_cell(entry, "orthomodes")
    outcome = _drive(cell)
    hop = drive.program_config(cell.config)[0].hop_size
    assert chunk_steps, entry
    assert outcome.failed == 0 and not outcome.missing, outcome.missing
    assert outcome.judged
    for item in outcome.judged:
        assert item.pcm.shape == (len(item.pool_index), hop, 1), item.key
        assert item.pcm.any(), item.key


@pytest.mark.parametrize("entry", sorted(ENTRY_CELL))
def test_a_coerced_field_fails_before_any_frame(chunk_steps, entry):
    """The OrthoModes family runs one channel: a file that says two fails
    with the field, both values and the family named, before a frame."""
    cell = _family_cell(entry, "orthomodes", channels=2)
    with pytest.raises(ValueError, match="channels") as err:
        _drive(cell)
    assert "orthomodes" in str(err.value)
    assert "says 2" in str(err.value) and "runs 1" in str(err.value)
    assert chunk_steps == []


@pytest.mark.parametrize("entry", sorted(ENTRY_CELL))
def test_an_unknown_family_fails(chunk_steps, entry):
    cell = _family_cell(entry, "no-such-family")
    with pytest.raises(ValueError, match="no-such-family"):
        _drive(cell)
    assert chunk_steps == []
