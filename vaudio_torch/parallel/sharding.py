"""SPMD execution of the auralizer over device meshes — the PyTorch port of
:mod:`vaudio.parallel.sharding`.

A :class:`StreamMesh` is an (n_stream, n_cell) grid of torch devices with
the JAX mesh's axis names.  A device may repeat: ``["cuda:0"] * 2`` lays a
(2, 1) or (1, 2) mesh over one card.  Where JAX runs one program on every
device under ``shard_map``, the port's single controller drives the shards
in mesh order:

* ``'stream'`` axis — data parallelism.  A stream shard is a block of rows
  of the leading stream axis, held on the first device of its mesh row
  (:class:`StreamShards`).  Each shard runs the port's stream-batched step
  (``runtime.step.frame_step``, ``runtime.chunked.chunk_pipeline``, an
  engine's ``raw_step``) on its rows.  Streams never communicate.
* ``'cell'`` axis — tensor parallelism inside the synthesis: every device
  of a row computes the vision and the phases (replicated, as JAX
  replicates them over ``'cell'``) and the partial spectrum of its
  ``num_cells / n_cell`` cells (kernel K2 at NP = 496 / n_cell).  The
  partial spectra are summed in cell order on the row's first device (the
  JAX ``psum``, :func:`_cell_sum`); the spectrum EMA and the audio tail run
  there once.

The quirk-compat phase layout makes per-cell phase reads non-local
(stride-22 reads cross the stride-32 cell boundaries,
SpectrumCompute.metal:135 vs SoundEngine.swift:269), so the 512-float
phase accumulator is whole on every cell device and only the gather
indices are sliced.

Params are replicated (the JAX ``P()``): each shard gets them as rows of
its streams, the form the stream-batched steps take.  The multi-process
pod (:mod:`vaudio_torch.parallel.hostpod`) shards per-slot params with the
streams instead.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from vaudio_torch import device as pick_device
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.dsp.core import hann_window_norm
from vaudio_torch.runtime.step import (StepCarry, default_params,
                                       frame_step, init_carry,
                                       params_to_device, synth_audio)
from vaudio_torch.synth.spectrum import (SynthConstants, contract_spectrum,
                                         finalize_spectrum, flatten_partials,
                                         live_pan_from_params,
                                         partial_weights, phase_accumulate)
from vaudio_torch.vision.features import extract_features

#: Cell-axis reductions so far: one a stream row a tensor-parallel step.
cell_reductions = 0


def process_index() -> int:
    """This process's rank in ``torch.distributed`` (0 when it is not
    initialized)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _norm_device(spec) -> torch.device:
    """``spec`` as a torch.device, a bare ``"cuda"`` with its index."""
    dev = torch.device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for a shard's launches."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class StreamMesh:
    """A ``('stream', 'cell')`` mesh: an (n_stream, n_cell) object array of
    torch devices (:attr:`devices`) and the process that owns each stream
    row (:attr:`processes`).  :attr:`shape` maps the axis names to their
    sizes, as a JAX ``Mesh.shape`` does."""

    def __init__(self, devices, processes=None):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh needs a non-empty (n_stream, n_cell) "
                             f"grid of devices; got shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = _norm_device(grid[idx])
        n_stream, n_cell = grid.shape
        self.processes = (np.full(n_stream, process_index())
                          if processes is None
                          else np.asarray(processes, dtype=np.int64))
        if self.processes.shape != (n_stream,):
            raise ValueError(f"processes: one per stream row ({n_stream}); "
                             f"got shape {self.processes.shape}")
        self.shape = {"stream": n_stream, "cell": n_cell}

    @property
    def local_rows(self) -> List[int]:
        """The stream rows this process drives, in mesh order."""
        me = process_index()
        return [r for r in range(self.shape["stream"])
                if self.processes[r] == me]


def local_cards() -> List[str]:
    """Every card of this process (``torch.cuda.device_count()``); without
    a card this raises as :func:`vaudio_torch.device` does."""
    pick_device(None)
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def make_stream_mesh(n_stream: Optional[int] = None, n_cell: int = 1,
                     devices=None) -> StreamMesh:
    """Build a ('stream', 'cell') mesh over ``devices`` (default
    :func:`local_cards`).  A device may repeat."""
    devices = list(local_cards() if devices is None else devices)
    if n_stream is None:
        n_stream = len(devices) // n_cell
    if n_stream < 1 or n_stream * n_cell != len(devices):
        raise ValueError(f"cannot lay {len(devices)} devices out as a "
                         f"({n_stream}, {n_cell}) mesh")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return StreamMesh(grid.reshape(n_stream, n_cell))


# ---------------------------------------------------------------------------
# Stream shards
# ---------------------------------------------------------------------------

def _is_named(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tensor, a NamedTuple or a dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if _is_named(tree):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


def _tree_cat(trees, device: torch.device):
    """Trees of one structure joined leaf by leaf along dim 0 on
    ``device``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], device) for k in first}
    if _is_named(first):
        return type(first)(*(_tree_cat([t[i] for t in trees], device)
                             for i in range(len(first))))
    return torch.cat([t.to(device) for t in trees])


def _first_leaf(tree):
    while isinstance(tree, dict) or _is_named(tree):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _leading(tree) -> int:
    """The leading (stream) size of a tree's first leaf."""
    return int(np.shape(_first_leaf(tree))[0])


def _put_leaf(x, dev: torch.device):
    """A leaf on ``dev``; a host array is always copied (a device put), a
    tensor moves only where it is not there yet."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    x = np.asarray(x)
    if dev.type == "cpu" or not x.flags.writeable:
        x = np.array(x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


class StreamShards(list):
    """A tree (a tensor, a NamedTuple carry or a dict of tensors) cut along
    its leading stream axis into the stream rows of a mesh that this
    process drives: part k holds the next block of rows, on
    ``devices[k]`` (its row's first device).  ``rows`` is the global
    stream range the parts hold, in order."""

    def __init__(self, parts, devices, rows: slice):
        super().__init__(parts)
        self.devices = list(devices)
        self.rows = rows

    def gather(self, device="cpu"):
        """The parts joined into one tree on ``device``."""
        return _tree_cat(list(self), torch.device(device))

    def numpy(self):
        """The parts joined on the host, as numpy."""
        return _tree_map(lambda x: x.numpy(), self.gather("cpu"))

    def map(self, fn) -> "StreamShards":
        """``fn`` applied to every part."""
        return StreamShards([fn(p) for p in self], self.devices, self.rows)


def shard_put(mesh: StreamMesh, tree) -> StreamShards:
    """Place a tree whose leading axis holds this process's streams over
    the process's stream rows of ``mesh``, an equal block of rows each (a
    copy per shard, complete when this returns)."""
    rows = mesh.local_rows
    if not rows:
        raise ValueError("this process owns no stream rows of the mesh")
    n = _leading(tree)
    if n % len(rows):
        raise ValueError(f"{n} streams do not split over {len(rows)} "
                         "stream shards")
    per = n // len(rows)
    devs = [mesh.devices[r, 0] for r in rows]
    parts = [_tree_map(lambda x, k=k: _put_leaf(x[k * per:(k + 1) * per],
                                                devs[k]), tree)
             for k in range(len(rows))]
    return StreamShards(parts, devs,
                        slice(rows[0] * per, (rows[-1] + 1) * per))


def _as_shards(mesh: StreamMesh, tree) -> StreamShards:
    return tree if isinstance(tree, StreamShards) else shard_put(mesh, tree)


def _host_params(params) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for k, v in params.items()}


def _replicated(params, n: int) -> dict:
    """Replicated params (the JAX ``P()``) as ``n`` rows of a shard."""
    return {k: np.array(np.broadcast_to(v, (n,) + v.shape))
            for k, v in _host_params(params).items()}


def _dp_step(mesh: StreamMesh, run_row, params_sharded: bool = False):
    """``step(carry, frames, params) -> (carry, out)`` running
    ``run_row(row, carry, frames, params)`` on each of this process's
    stream shards, the row's first device current.  ``carry`` and
    ``frames`` are :class:`StreamShards` or trees to place
    (:func:`shard_put`); the new carry and every ``out`` leaf come back as
    :class:`StreamShards`.  ``params`` are replicated, or with
    ``params_sharded`` lead with this process's streams."""
    rows = mesh.local_rows

    def step(carry, frames, params):
        carry = _as_shards(mesh, carry)
        frames = _as_shards(mesh, frames)
        host = _host_params(params) if params_sharded else None
        results, lo = [], 0
        for k, r in enumerate(rows):
            n = _leading(carry[k])
            p = ({key: v[lo:lo + n] for key, v in host.items()}
                 if params_sharded else _replicated(params, n))
            with _on(carry.devices[k]):
                results.append(run_row(r, carry[k], frames[k], p))
            lo += n
        new = StreamShards([c for c, _ in results], carry.devices,
                           carry.rows)
        out = {key: StreamShards([o[key] for _, o in results],
                                 carry.devices, carry.rows)
               for key in results[0][1]}
        return new, out
    return step


def _flagship_consts(cfg: AuralizerConfig, devices) -> dict:
    """The synthesis constants and the window on each of ``devices``."""
    consts = {}
    for dev in devices:
        if dev not in consts:
            consts[dev] = (SynthConstants.create(cfg, dev),
                           torch.as_tensor(hann_window_norm(cfg.nfft),
                                           device=dev))
    return consts


def init_carry_batch(cfg: AuralizerConfig, n_streams: int,
                     device=None) -> StepCarry:
    """Batched carry on ``device`` (the card unless given): every field
    gains a leading stream axis."""
    one = init_carry(cfg, device)
    return StepCarry(*(x.expand((n_streams,) + x.shape).contiguous()
                       for x in one))


def make_batched_step(cfg: AuralizerConfig, debug: bool = False,
                      jit: bool = True, device=None):
    """The one-device stream-batched step: ``step(carry[S, ...],
    frames[S, H, W, 3], params)`` with replicated params, through the
    port's stream-axis :func:`runtime.step.frame_step` on ``device`` (the
    card unless given).  ``jit`` is accepted and does nothing."""
    from vaudio_torch.runtime.engine import AuralizerEngine
    eng = AuralizerEngine(cfg, debug=debug, device=device)
    raw = eng.raw_step()

    def step(carry, frames, params):
        frames = _tree_map(lambda x: _put_leaf(x, eng.device), frames)
        return raw(carry, frames, _replicated(params, _leading(carry)))
    return step


# ---------------------------------------------------------------------------
# Tensor-parallel synthesis step
# ---------------------------------------------------------------------------

def _cell_sum(partials):
    """THE collective of the cell axis (the JAX ``psum`` over ``'cell'``):
    the partial spectra added in cell order on the first one's device —
    a fixed order, so the sum is deterministic."""
    global cell_reductions
    total = partials[0]
    for part in partials[1:]:
        total = total + part.to(total.device)
    cell_reductions += 1
    return total


def _tp_frame_step(carry: StepCarry, frame, params, cfg: AuralizerConfig,
                   consts: dict, row_devices, debug: bool):
    """One stream shard's frame step with the synthesis contraction split
    over the devices of its mesh row (``carry`` and ``frame`` on the first
    one).  Stereo (pan gains sliced per cell range) and enable_filters
    (applied after the sum, in the shared finalize stage) both compose
    with the split.  On a row of one device it is
    :func:`runtime.step.frame_step`."""
    dev0 = row_devices[0]
    if len(row_devices) == 1:
        c0, window = consts[dev0]
        return frame_step(carry, frame, params_to_device(params, cfg, dev0),
                          cfg, c0, window, debug=debug)
    local_cells = cfg.num_cells // len(row_devices)
    partials, first = [], None
    for c, dev in enumerate(row_devices):
        with _on(dev):
            cst = consts[dev][0]
            p = params_to_device(params, cfg, dev)
            fr = _tree_map(lambda x: x.to(dev), frame)
            # Vision + phase accumulation: replicated over the row.
            hues, grads = extract_features(fr, carry.hues.to(dev),
                                           p["spectrum_mixing"], cfg)
            phases = phase_accumulate(carry.phases.to(dev), hues, cfg, cst)
            cell_slice = (c * local_cells, local_cells)
            pfreq, w_re, w_im, inv_bw = partial_weights(
                hues, grads, phases, cfg, cst, cell_slice=cell_slice)
            flat = flatten_partials(pfreq, w_re, w_im, inv_bw, cfg,
                                    cell_slice=cell_slice,
                                    pan=live_pan_from_params(cfg, p, dev))
            partials.append(contract_spectrum(*flat, cfg, cst))
            if first is None:
                first = (hues, grads, phases, p)
    hues, grads, phases, p = first
    c0, window = consts[dev0]
    cur = _cell_sum(partials)
    spectrum = finalize_spectrum(cur, carry.prev_spectrum,
                                 p["spectrum_mixing"], cfg, c0,
                                 filter_params=p)
    pcm, ola_tail, running_max = synth_audio(
        spectrum, carry.ola_tail, carry.running_max, p, cfg, window)
    new_carry = StepCarry(hues=hues, phases=phases, prev_spectrum=spectrum,
                          ola_tail=ola_tail, running_max=running_max)
    out = {"pcm": pcm}
    if debug:
        out.update(hues=hues, grads=grads, spectrum=spectrum)
    return new_carry, out


def make_parallel_step(cfg: AuralizerConfig, mesh: StreamMesh,
                       debug: bool = False, jit: bool = True):
    """Mesh-sharded multi-stream step.

    Layout: carries/frames sharded over 'stream' (on each row's first
    device); synthesis cells split over 'cell' with one cell-order sum a
    row.  Returns ``step(carry, frames, params) -> (carry, out)``: carry
    and frames :class:`StreamShards` or trees with a leading stream axis
    (S a multiple of ``mesh.shape['stream']``), params replicated; the new
    carry and ``out["pcm"]`` as :class:`StreamShards`.  ``jit`` is
    accepted and does nothing."""
    n_cell = mesh.shape["cell"]
    if cfg.num_cells % n_cell:
        raise ValueError(
            f"num_cells {cfg.num_cells} not divisible by cell-axis size "
            f"{n_cell}")
    consts = _flagship_consts(
        cfg, [d for r in mesh.local_rows for d in mesh.devices[r]])

    def run_row(r, carry, frames, params):
        return _tp_frame_step(carry, frames, params, cfg, consts,
                              list(mesh.devices[r]), debug)
    return _dp_step(mesh, run_row)


def make_parallel_chunk_step(cfg: AuralizerConfig, mesh: StreamMesh,
                             debug: bool = False, jit: bool = True):
    """DP-sharded chunk-batched step: streams sharded over 'stream', each
    shard running the chunk-batched pipeline (runtime.chunked — one
    frame-batched contraction per shard-chunk) on its streams.  Zero
    communication.

    Requires the mesh's 'cell' axis to be 1 — the batched contraction is
    not cell-sharded (use make_parallel_step for latency-oriented TP).

    Returns ``step(carry, frames[S, T, ...], params) -> (carry, out)``
    with out["pcm"] of shape (S, T, hop[, channels]) as
    :class:`StreamShards`."""
    if mesh.shape.get("cell", 1) != 1:
        raise ValueError(
            "the chunk-batched parallel step is DP-only; build the mesh "
            f"with n_cell=1 (got cell={mesh.shape['cell']}) or use "
            "make_parallel_step for tensor parallelism")
    from vaudio_torch.runtime.chunked import chunk_pipeline
    consts = _flagship_consts(cfg, [mesh.devices[r, 0]
                                    for r in mesh.local_rows])

    def run_row(r, carry, frames, params):
        dev = mesh.devices[r, 0]
        cst, window = consts[dev]
        return chunk_pipeline(carry, frames,
                              params_to_device(params, cfg, dev), cfg, cst,
                              window, debug=debug)
    return _dp_step(mesh, run_row)


def _engine_step(engine, mesh: StreamMesh, chunk: bool,
                 params_sharded: bool):
    """The engine's raw per-frame or per-chunk step on each stream shard,
    through the engine on that shard's device."""
    steps = {}
    for r in mesh.local_rows:
        dev = mesh.devices[r, 0]
        if dev not in steps:
            eng = engine if _norm_device(engine.device) == dev \
                else engine.on_device(dev)
            steps[dev] = eng.raw_chunk_step() if chunk else eng.raw_step()

    def run_row(r, carry, frames, params):
        return steps[mesh.devices[r, 0]](carry, frames, params)
    return _dp_step(mesh, run_row, params_sharded=params_sharded)


def make_engine_parallel_step(engine, mesh: StreamMesh, chunk: bool = False,
                              jit: bool = True):
    """DP-sharded mesh step for ANY streaming engine
    (:mod:`vaudio_torch.runtime.engine`): carries/frames/outputs sharded
    over the 'stream' axis, params replicated, each shard through the
    engine's raw per-frame (or per-chunk) step on its device (the engine
    itself, or ``engine.on_device``).  Zero communication.

    No TP decomposition is assumed, so a 'cell' axis (if present) must be
    size 1 — cell-sharded synthesis is flagship-specific
    (:func:`make_parallel_step`)."""
    if mesh.shape.get("cell", 1) != 1:
        raise ValueError(
            "engine mesh pods are DP-only ('stream' axis); a 'cell' "
            f"axis of {mesh.shape['cell']} is flagship-specific tensor "
            "parallelism (make_parallel_step)")
    return _engine_step(engine, mesh, chunk, params_sharded=False)


def run_offline_parallel(frames, cfg: AuralizerConfig, mesh: StreamMesh,
                         params=None, debug: bool = False,
                         pipeline: str = "auto"):
    """Sonify a batch of clips over the mesh.

    Args:
      frames: [S, T, H, W, 3] — S streams of T frames (u8 or f32, host or
        device).
      pipeline: ``"chunked"`` = the DP-only chunk-batched pipeline (one
        frame-batched contraction per shard — the throughput shape);
        ``"scan"`` = the per-frame step under the full DP+TP mesh, frame by
        frame; ``"auto"`` picks chunked when the mesh has no cell axis to
        feed.
    Returns:
      (audio f32[S, T*hop] / f32[S, T*hop, ch], final carry as
      :class:`StreamShards`, dbg) — matching
      :func:`vaudio_torch.runtime.step.run_offline`, the audio and ``dbg``
      (per-frame hues/grads/spectrum stacks when ``debug``, leading axes
      (S, T, ...), else empty) on the mesh's first device.
    """
    if pipeline not in ("auto", "chunked", "scan"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if params is None:
        params = default_params(cfg)
    if pipeline == "auto":
        pipeline = "chunked" if mesh.shape.get("cell", 1) == 1 else "scan"
    n_streams = _leading(frames)
    dev0 = mesh.devices[mesh.local_rows[0], 0]
    carry = shard_put(mesh, init_carry_batch(cfg, n_streams, "cpu"))
    frames = shard_put(mesh, frames)

    if pipeline == "chunked":
        step = make_parallel_chunk_step(cfg, mesh, debug=debug)
        final, outs = step(carry, frames, params)
        outs = {k: v.gather(dev0) for k, v in outs.items()}
    else:
        step = make_parallel_step(cfg, mesh, debug=debug)
        per_frame = []
        for t in range(int(np.shape(_first_leaf(frames[0]))[1])):
            at_t = frames.map(lambda f, t=t: _tree_map(lambda x: x[:, t], f))
            carry, out = step(carry, at_t, params)
            per_frame.append({k: v.gather(dev0) for k, v in out.items()})
        final = carry
        outs = {k: torch.stack([o[k] for o in per_frame], dim=1)
                for k in per_frame[0]}
    pcm = outs.pop("pcm")
    if cfg.channels == 1:
        audio = pcm.reshape(n_streams, -1)
    else:
        audio = pcm.reshape(n_streams, -1, cfg.channels)
    return audio, final, outs

