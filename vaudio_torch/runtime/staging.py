"""Staging of an offline clip's frames on their way to the card: the
offline route's page-locked slice ring, beside the pod's tick staging
(:class:`vaudio_torch.runtime.multistream._TickStaging`) and sharing no
logic with it.

A clip in pageable host memory is cut into slices of its chunks
(:func:`slice_plan`, :func:`slice_frames`).  A staging thread walks the
slices in order: a pool of fill threads copies each slice into the next
buffer of a ring of :data:`RING` page-locked buffers
(``vaudio.ingest.stage``), then the staging thread queues the buffer's
DMA, ``non_blocking`` on a side stream, into the slice's rows of its
chunk's device tensor and records an event.  The dispatching thread only
waits, inside ``vaudio.ingest.frames``, for a chunk whose last slice has
not been queued yet, and makes the compute stream wait on that slice's
event.  So chunk k+1's bytes are filled and cross while chunk k is
dispatched and runs.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vaudio_torch.runtime.step import frames_slice, num_frames
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
#: The dtypes a staged clip may have: those that reach the card as they
#: are (u8, and f32, which an RGB clip of any other type becomes).
STAGED_DTYPES = (torch.uint8, torch.float32)

Plan = List[Tuple[int, int, List[Tuple[int, int]]]]


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


class OfflineStaging:
    """The offline route's host staging, owned by an ``Auralizer`` and
    kept across its ``sonify`` calls: a ring of :data:`RING` slice
    buffers, one a plane of a planar-YUV dict, page-locked when
    ``pinned``; made at the first staged clip and re-made only when the
    frame signature changes.  The fill threads, the staging thread and
    the copy stream are made at the first staged clip too.

    :meth:`chunks` hands a clip to the runtime chunk by chunk: staged for
    a host-resident clip of :data:`STAGED_DTYPES` bound for a CUDA
    device, else as slices of the clip as it is (the direct path, whose
    chunk step copies them).  Counters: ``staging_allocs`` (rings made),
    ``staging_reuses`` (staged clips through a kept ring),
    ``staged_chunks`` and ``direct_chunks``."""

    def __init__(self, pinned: bool = True):
        self.pinned = pinned
        self.allocs = 0
        self.reuses = 0
        self.staged_chunks = 0
        self.direct_chunks = 0
        self._sig = None
        self._bufs: List[Dict[Optional[str], torch.Tensor]] = []
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
    def engages(planes: Dict[Optional[str], torch.Tensor], device) -> bool:
        """Whether a clip (its planes; RGB under None) is staged: on the
        host, of a staged dtype, bound for a CUDA device."""
        return (torch.device(device).type == "cuda"
                and all(p.device.type == "cpu" and p.dtype in STAGED_DTYPES
                        for p in planes.values()))

    def ring(self, planes: Dict[Optional[str], torch.Tensor],
             per_slice: int) -> List[Dict[Optional[str], torch.Tensor]]:
        """The ring's buffers for frames like ``planes``' of
        ``per_slice`` frames a slice: kept when the signature is the last
        one, else (re)made once the DMAs that read the old ones are
        done."""
        sig = (per_slice, tuple((k, tuple(p.shape[1:]), p.dtype)
                                for k, p in planes.items()))
        if sig == self._sig:
            self.reuses += 1
            return self._bufs
        for ev in self._read:
            if ev is not None:
                ev.synchronize()
        self._read = [None] * RING
        self._bufs = [{k: torch.empty((per_slice,) + tuple(p.shape[1:]),
                                      dtype=p.dtype, pin_memory=self.pinned)
                       for k, p in planes.items()} for _ in range(RING)]
        self._sig = sig
        self.allocs += 1
        return self._bufs

    def fill(self, planes: Dict[Optional[str], torch.Tensor], s0: int,
             s1: int, buf: Dict[Optional[str], torch.Tensor],
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
