"""Frames on their way from host memory to the device, in one place: a
clip's shape (:func:`check_frames`), the host dtype rule
(:func:`host_dtype`), the direct crossing of every route
(:func:`to_device`), and the kept host buffers of the routes that stage
(:class:`HostBuffers`, page-locked where the device is CUDA): the pod's
tick and the stream's chunk (:meth:`HostBuffers.stack`), and the
offline slice ring (:class:`OfflineStaging`).  Nothing is made before
its first use.

The slice ring: a staging thread walks a host clip's slices
(:func:`slice_plan`) in order; fill threads copy each into the next of
:data:`RING` page-locked buffers (``vaudio.ingest.stage``), and the
staging thread queues the buffer's DMA, ``non_blocking`` on a side
stream, into the chunk's device tensor and records an event.  The
dispatching thread waits, inside ``vaudio.ingest.frames``, only for a
chunk not yet queued, and makes the compute stream wait on its event:
chunk k+1's bytes cross while chunk k is dispatched and runs.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vaudio_torch.io.sources import BorrowedFrame
from vaudio_torch.utils.profiling import span

#: Page-locked slice buffers in the ring: a slice fills while the one
#: before it crosses, with one more of slack.
RING = 3
#: A slice's byte budget.  The host allocator rounds a page-locked block
#: up to a power of two, so this is what a buffer of the ring holds: 5
#: frames at 2160x3840 RGB, 21 at 1080p.
SLICE_BYTES = 1 << 27
#: The most fill threads, whatever the CPUs.
MAX_FILL_THREADS = 8
#: A fill thread's share of a frame: what one thread copies into
#: page-locked memory (~3.5 GB/s) in the ~0.5 ms the chunk step's dispatch
#: takes a frame, at 1080p and at 4K alike.  More threads than keep the
#: fill at the dispatch's pace only take the CPUs and the memory
#: bandwidth that the dispatching thread needs.
FILL_BYTES_PER_THREAD = 1_750_000

Plan = List[Tuple[int, int, List[Tuple[int, int]]]]
Planes = Dict[Optional[str], torch.Tensor]


# ---- a clip on the host -----------------------------------------------------

def check_frames(frames):
    """A clip as tensors, not yet moved (a numpy array is shared, not
    copied): RGB (T, H, W, 3), or a dict ``{"y", "u", "v"}`` of planar
    YUV 4:2:0 (T, H, W), (T, H/2, W/2)."""
    if isinstance(frames, dict):
        planes = {k: _as_tensor(frames[k]) for k in ("y", "u", "v")}
        y = planes["y"]
        if y.ndim != 3 or any(planes[k].shape[0] != y.shape[0]
                              or planes[k].ndim != 3 for k in ("u", "v")):
            raise ValueError(f"expected YUV planes y [T, H, W], u and v "
                             f"[T, H/2, W/2]; got shapes "
                             f"{[tuple(p.shape) for p in planes.values()]}")
        return planes
    frames = _as_tensor(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected frames [T, H, W, 3]; got shape "
                         f"{tuple(frames.shape)}")
    return frames


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def num_frames(frames) -> int:
    """T of a clip: RGB frames or a dict of YUV planes."""
    return len(frames["y"] if isinstance(frames, dict) else frames)


def frame_at(frames, t: int):
    """Frame ``t`` of a clip: (H, W, 3), or a dict of its YUV planes."""
    if isinstance(frames, dict):
        return {k: v[t] for k, v in frames.items()}
    return frames[t]


def frames_slice(frames, start: int, end: int):
    """Frames ``start:end`` of a clip (each plane of a YUV dict)."""
    if isinstance(frames, dict):
        return {k: v[start:end] for k, v in frames.items()}
    return frames[start:end]


# ---- the host dtype rule and the direct crossing ----------------------------

def host_dtype(dtype):
    """The host dtype rule: the dtype in which an RGB frame of ``dtype`` (a
    NumPy or a torch dtype) crosses to the device, of the same kind.  u8
    stays u8, a quarter of f32's bytes over the link; any other type
    becomes f32.  A planar-YUV frame's planes cross as they are."""
    if isinstance(dtype, torch.dtype):
        return torch.uint8 if dtype == torch.uint8 else torch.float32
    return np.dtype(np.uint8 if dtype == np.uint8 else np.float32)


def host_frames(frames):
    """``frames`` (one frame or a clip: RGB, or a dict of planar-YUV
    planes; NumPy or tensors) in the host dtype, where they are: not
    copied where the dtype holds, and a NumPy subclass (a borrowed pool
    view) kept."""
    if isinstance(frames, dict):
        return {k: v if isinstance(v, torch.Tensor) else np.asanyarray(v)
                for k, v in frames.items()}
    if isinstance(frames, torch.Tensor):
        return frames.to(host_dtype(frames.dtype))
    frames = np.asanyarray(frames)
    return frames.astype(host_dtype(frames.dtype), copy=False)


def to_device(frames, device=None, copy: bool = False,
              put: Optional[Callable] = None):
    """``frames`` (as :func:`host_frames` takes them) as tensors on
    ``device`` in the host dtype, by a synchronous copy.  A tensor on its
    device comes back as it is (an offline clip on the CPU) unless
    ``copy`` (out of a buffer the caller rewrites); a borrowed pool view
    bound for the CPU is always copied.  ``put`` places the frames instead
    (the pod's mesh).  Inside ``vaudio.ingest.frames`` unless every plane
    is a tensor off the host or bound for the CPU and no copy is asked."""
    frames = host_frames(frames)
    if put is not None:
        with span("vaudio.ingest.frames"):
            return put(frames)
    dev = torch.device(device)
    planes = frames.values() if isinstance(frames, dict) else (frames,)
    if not copy and all(isinstance(p, torch.Tensor)
                        and (p.device.type != "cpu" or dev.type == "cpu")
                        for p in planes):
        return _moved(frames, dev, False)
    with span("vaudio.ingest.frames"):
        return _moved(frames, dev, copy)


def _moved(frames, dev: torch.device, copy: bool):
    if isinstance(frames, dict):
        return {k: _moved(v, dev, copy) for k, v in frames.items()}
    if not isinstance(frames, torch.Tensor):
        if dev.type == "cpu" and isinstance(frames, BorrowedFrame):
            frames = np.array(frames)     # as_tensor would share its slot
        frames = torch.as_tensor(np.asarray(frames))
    return frames.to(dev, copy=copy)


# ---- kept host buffers -----------------------------------------------------

def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (a torch dtype as it is)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


class HostBuffers:
    """Host buffers for frames bound for ``device``, page-locked where it
    is CUDA: a set of buffers, one tensor a plane (RGB under None), kept
    until its layout changes.  ``allocs`` counts the sets made,
    ``reuses`` the uses of a kept one."""

    def __init__(self, device):
        self.pinned = torch.device(device).type == "cuda"
        self.allocs = 0
        self.reuses = 0
        self.bufs: List[Planes] = []
        self._key = None

    def take(self, layout: Dict[Optional[str], Tuple[tuple, object]],
             copies: int = 1,
             retire: Optional[Callable[[], None]] = None) -> List[Planes]:
        """``copies`` buffers of ``layout`` (plane: (shape, NumPy or torch
        dtype)): the kept set, or a new one made once ``retire()`` has
        waited for the last readers of the old."""
        key = (copies, tuple(sorted(layout.items(),
                                    key=lambda kv: str(kv[0]))))
        if key == self._key:
            self.reuses += 1
            return self.bufs
        if retire is not None and self.bufs:
            retire()
        self.bufs = [{k: torch.empty(shape, dtype=_torch_dtype(dt),
                                     pin_memory=self.pinned)
                      for k, (shape, dt) in layout.items()}
                     for _ in range(copies)]
        self._key = key
        self.allocs += 1
        return self.bufs

    def stack(self, frames: Sequence, chunked: bool = False):
        """``frames`` copied into the kept buffer on a leading axis (the
        pod's tick, the stream's chunk; ``chunked``: each slot's frames,
        (S, T, ...)), so borrowed pool views are consumed here: its tensor,
        or a dict of them a plane, until the next stack rewrites it."""
        first = frames[0][0] if chunked else frames[0]
        lead = ((len(frames), len(frames[0])) if chunked
                else (len(frames),))
        planes = first if isinstance(first, dict) else {None: first}
        buf, = self.take({k: (lead + v.shape, v.dtype)
                          for k, v in planes.items()})
        for k, b in buf.items():
            out = b.numpy()
            for row, fs in (zip(out, frames) if chunked else [(out, frames)]):
                np.stack([f if k is None else f[k] for f in fs], out=row)
        return buf[None] if None in buf else dict(buf)


# ---- the offline route's slice ring -----------------------------------------

def slice_frames(frame_bytes: int) -> int:
    """The most frames of ``frame_bytes`` each in one slice: as many as
    :data:`SLICE_BYTES` holds, at least one."""
    return max(1, SLICE_BYTES // frame_bytes)


def slice_plan(T: int, chunk: int, per_slice: int) -> Plan:
    """The slices of a clip of ``T`` frames, for each of its chunks of
    ``chunk`` frames (the last may be shorter): ``(c0, c1, [(s0, s1),
    ...])``, the chunk's frames cut into as few slices of at most
    ``per_slice`` frames as will do, their lengths apart by at most one,
    in order.  A slice never crosses a chunk."""
    plan = []
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        n = c1 - c0
        k = -(-n // per_slice)
        cuts = [c0 + n * i // k for i in range(k + 1)]
        plan.append((c0, c1, list(zip(cuts[:-1], cuts[1:]))))
    return plan


def fill_threads(frame_bytes: int) -> int:
    """The fill's threads for frames of ``frame_bytes``: one for each
    :data:`FILL_BYTES_PER_THREAD` of a frame, but no more than the CPUs
    this process may run on less one for the dispatching thread, nor
    than :data:`MAX_FILL_THREADS`."""
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)
    return max(1, min(MAX_FILL_THREADS, cpus - 1,
                      -(-frame_bytes // FILL_BYTES_PER_THREAD)))


def row_parts(n: int, rows: int, parts: int):
    """``parts`` runs of the ``n * rows`` rows of ``n`` frames, as lists
    of (frame, first row, end row): equal shares of rows, in order, that
    together cover every row of every frame once."""
    total = n * rows
    cuts = [total * i // parts for i in range(parts + 1)]
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        run = []
        while a < b:
            f = a // rows
            r1 = min(b - f * rows, rows)
            run.append((f, a - f * rows, r1))
            a = f * rows + r1
        out.append(run)
    return out


def _copy_rows(dst: np.ndarray, src: np.ndarray, run) -> None:
    with span("vaudio.ingest.stage"):
        for f, r0, r1 in run:
            np.copyto(dst[f, r0:r1], src[f, r0:r1])


class OfflineStaging(HostBuffers):
    """The offline route's host staging, owned by an ``Auralizer`` and
    kept across its ``sonify`` calls: its kept set is a ring of
    :data:`RING` slice buffers, made at the first staged clip like the
    fill threads, the staging thread and the copy stream.

    :meth:`chunks` hands a clip to the runtime chunk by chunk: staged for
    a host-resident clip that crosses in its own dtype, bound for a CUDA
    device, else as slices of the clip as it is (the direct path, whose
    chunk step copies them).  Counters: ``staging_allocs`` (rings made),
    ``staging_reuses`` (staged clips through a kept ring),
    ``staged_chunks`` and ``direct_chunks``."""

    def __init__(self, device):
        super().__init__(device)
        self.staged_chunks = 0
        self.direct_chunks = 0
        # The event of the DMA that last read each ring buffer.
        self._read: List[Optional[torch.cuda.Event]] = [None] * RING
        self._copy_stream = None
        self._fill = None
        self._stager = None

    def metrics(self) -> Dict[str, int]:
        return {"staging_allocs": self.allocs,
                "staging_reuses": self.reuses,
                "staged_chunks": self.staged_chunks,
                "direct_chunks": self.direct_chunks}

    @staticmethod
    def engages(planes: Planes, device) -> bool:
        """Whether a clip (its planes; RGB under None) is staged: on the
        host, each plane in a dtype the host dtype rule keeps, bound for a
        CUDA device."""
        return (torch.device(device).type == "cuda"
                and all(p.device.type == "cpu"
                        and host_dtype(p.dtype) == p.dtype
                        for p in planes.values()))

    def ring(self, planes: Planes, per_slice: int) -> List[Planes]:
        """The ring's buffers for frames like ``planes``' of
        ``per_slice`` frames a slice: kept when the signature is the last
        one, else (re)made once the DMAs that read the old ones are
        done."""
        return self.take({k: ((per_slice,) + tuple(p.shape[1:]), p.dtype)
                          for k, p in planes.items()}, RING, self._retire)

    def _retire(self) -> None:
        for ev in self._read:
            if ev is not None:
                ev.synchronize()
        self._read = [None] * RING

    def fill(self, planes: Planes, s0: int, s1: int, buf: Planes,
             threads: int) -> None:
        """Frames ``s0:s1`` of each plane into the head of its buffer,
        each plane's rows cut into ``threads`` parts for the fill threads;
        returns when every part is copied."""
        if self._fill is None:
            self._fill = ThreadPoolExecutor(MAX_FILL_THREADS,
                                            thread_name_prefix="vaudio-fill")
        n = s1 - s0
        futs = []
        for k, p in planes.items():
            src = p.detach().numpy()[s0:s1]
            dst = buf[k].numpy()[:n]
            for run in row_parts(n, src.shape[1], threads):
                futs.append(self._fill.submit(_copy_rows, dst, src, run))
        wait(futs)
        for f in futs:
            f.result()

    def chunks(self, frames, chunk: int, device) -> Iterator:
        """The clip's chunks of ``chunk`` frames, in order, as the chunk
        step takes them: staged on the card, or direct.  Close the
        iterator (``contextlib.closing``) when done with it: a staged clip
        returns only after every fill that reads the caller's memory has
        finished."""
        planes = frames if isinstance(frames, dict) else {None: frames}
        T = num_frames(frames)
        if not (T and self.engages(planes, device)):
            for c0 in range(0, T, chunk):
                self.direct_chunks += 1
                yield frames_slice(frames, c0, c0 + chunk)
            return
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        frame_bytes = sum(p[0].numel() * p.element_size()
                          for p in planes.values())
        per_slice = slice_frames(frame_bytes)
        plan = slice_plan(T, chunk, per_slice)
        bufs = self.ring(planes, per_slice)
        if self._copy_stream is None or self._copy_stream.device != dev:
            self._copy_stream = torch.cuda.Stream(device=dev)
        if self._stager is None:
            self._stager = ThreadPoolExecutor(
                1, thread_name_prefix="vaudio-stage")
        compute = torch.cuda.current_stream(dev)
        ready: queue.Queue = queue.Queue()
        freed: queue.Queue = queue.Queue()
        cancel = threading.Event()
        job = self._stager.submit(self._stage, planes, plan, bufs,
                                  fill_threads(frame_bytes), dev, ready,
                                  freed, cancel)
        try:
            for _ in plan:
                with span("vaudio.ingest.frames"):
                    got = ready.get()
                    if isinstance(got, Exception):
                        raise got
                    dst, ev = got
                    del got
                    compute.wait_event(ev)
                    for plane in dst.values():
                        plane.record_stream(compute)
                self.staged_chunks += 1
                yield dst if isinstance(frames, dict) else dst[None]
                del dst, plane
                # The chunk is dispatched; once the card has run it, its
                # device memory may take the chunk after next.
                done = torch.cuda.Event()
                done.record(compute)
                freed.put(done)
        finally:
            cancel.set()
            freed.put(None)
            job.result()

    def _stage(self, planes, plan: Plan, bufs, threads: int, dev,
               ready: queue.Queue, freed: queue.Queue,
               cancel: threading.Event) -> None:
        """The staging thread's walk over a clip's slices (see the module
        docstring).  A chunk's device tensors are made on the copy stream
        once the chunk two before it has run, so at most two chunks are
        on the card; a ring buffer is refilled only once the DMA that last
        read it is done.  Failures reach the dispatching thread through
        ``ready``."""
        try:
            copy = self._copy_stream
            j = 0
            with torch.cuda.device(dev):
                for c, (c0, c1, slices) in enumerate(plan):
                    if c >= 2:
                        done = freed.get()
                        if done is None:
                            return
                        done.synchronize()
                    with torch.cuda.stream(copy):
                        dst = {k: torch.empty((c1 - c0,) + tuple(p.shape[1:]),
                                              dtype=p.dtype, device=dev)
                               for k, p in planes.items()}
                    for s0, s1 in slices:
                        if cancel.is_set():
                            return
                        b = j % RING
                        j += 1
                        if self._read[b] is not None:
                            self._read[b].synchronize()
                        self.fill(planes, s0, s1, bufs[b], threads)
                        with torch.cuda.stream(copy):
                            for k in dst:
                                dst[k][s0 - c0:s1 - c0].copy_(
                                    bufs[b][k][:s1 - s0], non_blocking=True)
                            ev = torch.cuda.Event()
                            ev.record(copy)
                        self._read[b] = ev
                    ready.put((dst, ev))
                    del dst
        except Exception as e:           # raised on the dispatching thread
            ready.put(e)
