#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``vaudio_torch``) on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: torch, CUDA, nvcc, the card's name and power limit;
2. build the CUDA kernels from ``vaudio_torch/csrc`` (one ``nvcc`` per
   source, all at once, into ``build/vaudio_torch/``);
3. K1, the u8 mip pool, against its plain PyTorch version on
   u8 [T, 1080, 1920, 3] frames at mip 3, T = 1, 8 and 64: integer block
   sums exact, the 1/255 mips bit for bit, an odd crop at levels 1 and 7;
   both times and the share of the bound at each T;
4. K1's planar and YUV entries on one 1080p YUV 4:2:0 chunk, Y
   [64, 1080, 1920] at mip 3 and U, V [64, 540, 960] at mip 2: the planar
   entry's sums exact and its studio-swing mips bit for bit; the YUV entry
   (one launch from the planes to the clamped RGB mips) bit for bit
   against its plain version, on the chunk and on an odd crop at levels
   1-7; the T=1 and two-call bit checks; times of one YUV dispatch and of
   the planar entry on Y at T=64 and T=1 and their share of the bound;
5. K2, the Hann-peak contraction, against its plain version at T=64,
   F=2047, NP=496, K=2 and 4, at T=8, K=4 (the chunked live path's) and K2'
   at T=1: within 1e-5; frames 0, T/2 and T-1 of the T=64 call equal to
   T=1 calls on the same inputs and two calls equal, bit for bit; both
   times;
6. the offline path: ``Auralizer(config=AuralizerConfig(sample_rate=48000.0,
   channels=2), device="cuda").sonify`` on 64 structured u8 1080p frames,
   then on the same kind of clip as planar I420 YUV dicts (BT.601 studio
   swing, ``tests/torch_frames.py``), with the kernels' launch counts reset
   before and read after (K1: the interleaved entry, or exactly one launch
   of the YUV entry a chunk and none of the others; K2 and K4, which runs
   once for the chunk of 64); each clip
   cropped to 256x256 through the port on the card and on the CPU (equal
   hue sequences, PCM within 1e-4);
7. K3, the vision epilogue, against its plain version on the mips of
   structured 1080p frames (135 x 240) at T=64, 8 and 1: counts exact,
   statistics within atol 1e-6, rtol 1e-5; the same bit checks as K2 (T=1
   against the batch, two calls); both times;
8. K4, AGC + overlap-add, in both op orders (the frame order frame by
   frame, as frame_step calls it), mono and stereo, at T = 1, 8 and 64
   (and nfft 8192, and a hop not a multiple of 4), and on edge frames:
   within 1e-6 of its plain version on the card and on the CPU; a T=64
   chunk-order call equal to 64 chained T=1 calls and to a second call,
   bit for bit; one device kernel per call; both times at T=1 (frame
   order), 8 and 64 (chunk order);
9. the live path: ``Auralizer(source=frames, config=..., device="cuda")
   .run_until_exhausted()`` on 64 structured 1080p frames, RGB and then YUV
   dicts, with ``use_pallas`` and ``use_pallas_vision``, per frame and in
   chunks of 8, the counts reset before each run and read after it (K1:
   the interleaved entry, or exactly one launch of the YUV entry a
   dispatch and none of the others; K2-K4 in both; K4 64 times
   per frame, 8 times in chunks); the pulled PCM equal to ``run_offline``
   on the card; a 256x256 crop through the same configuration on the card
   and on the CPU (equal hues, PCM within 1e-4); YUV's ms/frame beside
   RGB's;
10. a profile of the live path under torch.profiler, RGB and YUV: device
    events per frame by kind, host-to-device copies per dispatch, the
    device's busy share of the wall clock;
11. the config flags (quantize_mips, quantize_mips_int8,
    linear_cell_grads=False, use_phase_lut, use_matmul_ema,
    use_matmul_irfft): each offline on the 64 RGB frames beside the default
    config, with its launch counts and a 32-frame 256x256 crop card vs CPU
    (equal hues, PCM within 1e-4); the LUT's PCM equal to the default's bit
    for bit; the dense irfft's time beside torch.fft.irfft's;
12. the debug surface: ``sonify(debug=True)`` (PCM equal to debug=False,
    the JAX package's shapes) and ``inspect_frame`` on a 1080p frame;
13. a real-time stream: 90 frames paced at 30 fps, its latency p50 / p99
    and achieved fps, no frame dropped;
14. native: the C++ host runtime (``vaudio_torch/native``: the audio ring
    and the read-ahead frame reader) built with g++, its time (right after
    the kernels' build);
15. serve: the network-serving front door at ``live_config()``:
    ``Auralizer(source=PushSource(maxsize=64, when_empty="block"),
    device="cuda").serve(port=0)`` fed 64 frames over HTTP (``POST
    /frames``: ``.npy`` RGB bodies through ``push_frames``, raw I420
    bodies with ``?w=&h=&fmt=i420``), per frame and in chunks of 8, the
    counts reset before each run and read after it (paths ``serve``,
    ``serve_chunk``, ``serve_yuv``, ``serve_yuv_chunk``: K4 once a
    dispatch, 64 times per frame; on I420 exactly one launch of K1's YUV
    entry a dispatch and none of the others; every kernel of the path);
    nothing dropped, the ring a ``NativeRingBuffer``, the pulled PCM equal
    bit for bit to the offline runs on the card with the stream's
    dispatches; ``/metrics``, ``/metrics.prom``, the four PNG views, ``POST
    /params``, a ``/state.npz`` round trip and a malformed frame's 400;
    ms/frame beside the in-process live run's; a served stream per frame
    under torch.profiler (device events per frame, idle share);
16. native reader: 64 frames of 1080p rgb24 and I420 from a file through
    ``RawVideoSource(native=True, zero_copy=True)`` (borrowed pool views):
    PCM equal to the in-memory source's run;
17. paced: 90 frames pushed at 30 fps (``push_frames(fps=30)``) into the
    default ``maxsize=8`` queue, ``GET /audio.wav`` the only consumer:
    latency p50 / p99, fps, dropped frames, the WAV's RIFF header and
    non-silence;
18. OrthoModes offline: ``Auralizer(model="orthomodes", device="cuda")
    .sonify`` on the 64 1080p frames (stereo 48 kHz asked, coerced to mono;
    1980 oscillators at mip 5), from host and from device frames: K1 and K4
    exactly once for the block of 64 and no other kernel, a profile of the
    run, the 256x256 crop card vs CPU (PCM within 1e-4), and the plain
    Hann x Lorentzian synthesis's device time per frame at T = 1 and 16
    beside its bound (K1 at mip 5, T = 1 and 64, and K4's frame order at
    T = 8 and 64, mono, are held to their plain versions in phases 3 and 8);
19. OrthoModes live, per frame and in chunks of 8, 64 frames: K1 and K4
    once a dispatch, the PCM equal bit for bit to the model's steps on the
    card with the stream's dispatches; 16 frames of each under the
    profiler;
20. OrthoModes served: 64 ``.npy`` RGB frames through ``POST /frames``:
    ``/state.npz`` 409 before the first frame, an I420 body 400, PCM equal
    to the model's steps, and ``/state.npz`` after 32 frames restored into
    a fresh served stream whose PCM continues the uninterrupted run bit for
    bit;
21. OrthoModes resolution change (1080p then 720p: counted, the 720p part
    equal to a cold run) and a 720p checkpoint on 1080p frames failing with
    the oscillator-count message;
22. K4's stream axis (the serving pod's): S streams of very different
    loudness in one launch, at S = 8, T = 8 stereo in the chunk order, S =
    8 in the frame order (T = 1) and S = 2, T = 8 mono in the frame order
    at T frames: within 1e-6 of the plain version (S plain calls), each
    stream equal bit for bit to a launch on it alone; both times;
23. the serving pod, ``MultiStreamAuralizer(cfg, n_streams=S,
    engine=...)``: the flagship's live configuration, S = 4 slots of 1080p
    stereo from distinct slices of the frames (slot 3 ends early, a dark
    slot), per frame for 16 ticks and in chunks of 8 for 16 frames; the
    same pod on I420 dicts per frame; OrthoModes, S = 2 at mip 5 in chunks
    of 8: K1, K2, K3 and K4 (OrthoModes: K1 and K4) once a tick whatever
    S; each slot's PCM against its single-stream run on the card (bit for
    bit where it is, else within 2e-6; hues equal); a pod checkpointed
    after 8 frames and restored into a second pod continuing bit for bit;
    ms a tick, aggregate frames/s, device events a tick and the device's
    idle share under the profiler;
24. the serving pod behind its HTTP panel (``pod.serve(port=0)``), driven
    by ``vaudio_torch.client.PodClient``: S = 4 slots leased with
    ``acquire(maxsize=16, when_empty="dark")`` and filled before
    ``pod.start`` (so that each tick sees what the in-process pod's does),
    per frame over ``.npy`` RGB bodies and in chunks of 8 over raw I420
    bodies; OrthoModes S = 2 in chunks of 8, and its ``/state.npz`` after
    8 frames POSTed into a second served pod that finishes the clips: K1,
    K2, K3 and K4 (OrthoModes: K1 and K4) once a tick, the counts set to 0
    before the first request and read after the last; each slot's PCM
    equal bit for bit to the in-process pod's on the same frames, slot 0's
    through ``/slots/0/audio.wav`` (``PodSlot.record``) as the WAV
    quantises it; ``/metrics``' ``frame_sig`` equal to
    ``client.frame_sig_json``; the four slot views (OrthoModes' hue view
    404); ms a tick, aggregate frames/s and the ms of one push of each
    body kind;
25. the local meshes of ``vaudio_torch.parallel`` over the card (distinct
    cards where there are enough, else the card's device repeated) at
    the live configuration, S = 4 slots of 1080p: ``make_parallel_step``
    on (2,1), (1,2), (2,2) and (2,4) for 8 ticks against the one-device
    batched step (DP bit for bit, TP within 3e-4 with the measured
    maximum, hues equal), K1, K3 and K2' counted n_stream * n_cell times
    a tick and K4 n_stream times, the cell sums n_stream a tick;
    ``make_parallel_chunk_step`` and OrthoModes'
    ``make_engine_parallel_step`` (mono, mip 5) on (2,1) in chunks of 8
    (within 2e-6, and bit for bit); the mesh pod
    (``MultiStreamAuralizer(mesh=..., params=shared)``) per frame on every
    shape and in chunks of 8 on (2,1), 16 frames a slot, each slot against
    the one-device pod with its launches counted, and the (2,1) and (2,2)
    pods per frame under the profiler (device events a tick, idle share);
    K2 at the cell shards' widths NP = 248 and 124 (T = 2) against its
    plain version with phase 5's checks (two rows of the kernels line);
    ``dryrun_multichip(4)``; the pods' ms a tick beside the one-device
    pod's ("one card, device repeated: not a scaling figure");
26. two child processes on the card run ``tests/torch_hostpod_driver.py``
    (torch.distributed on Gloo over host flags, each child's device
    cuda:0): one 4-slot global ``MultiHostPod`` at the live configuration,
    8 frames of 1080p a slot, per frame and in chunks of 8, each global
    slot against the single-process pod (bit for bit per frame, within
    2e-6 in chunks), each child's K1-K4 once a tick and its ms a tick
    after a warm-up pod; a child still running past the watchdog's
    remaining time is killed and the phase fails; then a world-of-one
    ``MultiHostAuralizer`` through ``init_distributed``;
27. the command line, each command a process of its own from the
    repository's root with the repository on PYTHONPATH, on the card by
    default, loading the kernels phase_build built (counted runs go
    through ``CLI_PRELUDE``, which runs the package's ``__main__`` as
    ``python -m vaudio_torch`` does and writes the launch counts and the
    start-up's parts at exit), 1080p at 48 kHz: ``sonify`` of 64 .npy
    frames stereo with ``--pallas`` and mono ``--model orthomodes`` (each
    WAV equal bit for bit to the in-process ``sonify_to_wav``'s; K1, K2 and
    K4 once, OrthoModes K1 and K4); ``stream`` in pipe mode from a raw
    rgb24 file of 64 frames, per frame and in chunks of 8 (stdout's PCM
    equal bit for bit to the in-process run with the dispatches read from
    ``--metrics-log``; K1, K2' or K2 and K4 once a dispatch); ``stream
    --trace`` on 16 frames (the torch.profiler trace shows K1, K2' and K4
    16 times each); ``pod`` with 4 raw rgb24 file slots of 16 frames per
    frame (each slotN.wav equal to the in-process pod's bit for bit); ``pod
    --serve`` with a ``push`` and a ``push:dark`` slot fed by a ``push``
    process of 16 .npy frames and read by a ``pull`` process (exit 0, every
    frame taken, no slot failed, the WAVs finite and non-empty); two ``pod
    --coordinator`` processes on Gloo with 2 slots of 8 frames each (every
    global slot equal to the single-process pod's bit for bit); ``doctor
    --json`` (no fail, the card named, kernels and smoke ok) and ``info``;
    each command's wall time, start-up (import, CUDA context, kernel load)
    and ms a frame or a tick beside the in-process figure;
28. ``vaudio_torch.entry.entry()``: its fn on its 1080p example inputs and
    on a structured frame, pcm f32[2048], finite, equal bit for bit to
    ``frame_step``;
29. the port against the reference's literal f64 math
    (``vaudio_torch.utils.parity``; the oracle itself runs in two child
    processes on the host's CPU from before phase 26): the ``parity``
    command's input (3 f32 frames of 128^2) through the per-frame runner,
    and 4 structured u8 1080p frames, mono, with ``use_pallas`` and
    ``use_pallas_vision``, through the per-frame and the chunked runners
    against one oracle run, hues equal and within the JAX harness's gates,
    the kernels counted (paths ``oracle_parity``, ``oracle_frame``,
    ``oracle_chunk``); then ``audit_stages`` at 1080x1920, every stage
    within its tolerance, each beside the TPU audit's figure
    (``benchmarks/TPU_PARITY_r05.json``, read as data);
30. the headline benchmark, ``python -m vaudio_torch bench``, as a child
    process at 1080p with the default chunks 16,128 (stereo chunked, the
    blocked scan in 8s, mono), 4 calls a timed loop and at most 4 reps:
    its JSON line beside the card's name and power limit, failing without
    a line, with ``value`` <= 0 or with ``fallback_upper_bound`` (the child
    itself fails if K1, K2 or K4 did not launch); then one call of its
    chunked callable on 16 device frames in process, counted (path
    ``bench``: K1, K2 and K4 once), its PCM equal bit for bit to
    ``run_offline_batched``'s on the same frames;
31. the 4K configuration, 2160x3840 (mip 3 = 270x480, which K3's gate
    refuses in both packages), on structured clips made by two child
    processes from before phase 3: K1's interleaved entry at T = 1,
    8 and 64, its YUV and planar entries at T = 64 and 1, each bit for
    bit against its plain version, with the column tiles its launch took
    (``ops.pool_kernel.launch_plan``), both times, the bound and its
    share; K3 called directly at T = 8 and 1 (counts equal to the plain
    version's, statistics within atol 1e-6, rtol 1e-5) beside the unfused
    stages' time a frame; ``Auralizer.sonify`` at chunk 64 with
    ``use_pallas_vision`` on 64 RGB frames from host and from device
    memory (PCM equal) and 64 I420 frames, K1, K2 and K4 once and K3
    never, ms a frame, peak device memory, 2 frames card vs CPU (hues
    equal, PCM within 1e-4); the live stream on 64 frames per frame and
    in chunks of 8 (PCM equal to the offline runs on the card, K3 never)
    with 16 frames of each under the profiler, and 90 frames paced at 30
    fps with no frame dropped; 16 raw I420 frames (12.4 MB bodies)
    through ``POST /frames`` (PCM equal to the offline run with the
    stream's dispatches); and phase 30's bench child and counted call at
    ``VAUDIO_BENCH_RES=2160x3840`` (``static_floor_us`` 7.96).

Each kernel's line gives two times: from CUDA events around a loop of calls
(``ms``; for a small kernel the host's launch overhead sets it) and the
sum of its device events under torch.profiler (``device_ms``).

The last lines are the card's name and power limit, a JSON line of the
kernels, and ``{"ok": true, "device": {...}}``.  There is no fallback to the
CPU: without a card the script fails.

A request to a served stream that takes over 10 s prints every thread's
stack to stderr and goes on waiting (up to 300 s); a run that is still going
after 1140 s prints them and exits non-zero.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import faulthandler
import functools
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

MIP = 3
ORTHO_MIP = 5                    # OrthoModesConfig's default mip level
CHUNK_T = 64                     # the offline path's chunk (run_offline_batched)
LIVE_T = 64                      # frames of each live run
LIVE_CHUNK = 8                   # the chunked live run's chunk_frames
HTTP_TIMEOUT_S = 300             # a request to a served stream
STALL_S = 10                     # a request slower than this prints stacks
RUN_LIMIT_S = 1140               # the watchdog's limit on the whole run
_deadline = None                 # main()'s start + RUN_LIMIT_S (monotonic)
REALTIME_T = 90                  # frames of the paced real-time run
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth, and f32 outside the tensor cores (the kernels' operations are
# CUDA-core f32 and integer work).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per peak evaluation of K2: the distance (2) and
# hann_sinc_peak_fast (rint, the reduced fraction, the 5-term polynomial,
# the parity sign, the factored numerator and denominator, one divide, the
# limits: 25); K2 adds 2 per output column (a multiply-add).
K2_PEAK_OPS = 27
# Operations per mip pixel of K3, counted from csrc/vision_kernel.cu: HSI and
# gate ~20, the acos ~15, the bin and cell ~12, the stencils with the
# rolling intensity row ~27, the statistics 8, the histogram add 1 (~83;
# 90 with the loop and index arithmetic).
K3_PIXEL_OPS = 90


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


_CHILDREN = []                   # every process spawn() started
_PRCTL = ctypes.CDLL(None, use_errno=True).prctl
PR_SET_PDEATHSIG = 1


def _die_with_parent() -> None:
    """In the child, before its exec: SIGKILL when this script ends, also
    where it ends without running atexit (the watchdog's exit)."""
    _PRCTL(PR_SET_PDEATHSIG, signal.SIGKILL)


def spawn(cmd: list, **kw) -> subprocess.Popen:
    """subprocess.Popen in a session of its own, killed with everything it
    started at this script's exit (stop_children), a failed run's too."""
    proc = subprocess.Popen(cmd, preexec_fn=_die_with_parent,
                            start_new_session=True, **kw)
    _CHILDREN.append(proc)
    return proc


def stop_children() -> None:
    """Kill every spawned process's session and reap the processes."""
    for proc in _CHILDREN:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


atexit.register(stop_children)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` in ms, from CUDA events around a loop
    of ``reps`` calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps: int):
    """The device events (kernels and copies) of ``reps`` calls of ``fn``
    under torch.profiler, after a warm-up: a list of (name, µs)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the sum of its kernels' and
    copies' durations from torch.profiler (no host gaps), over ``reps``.
    The profiler can lose device records but never adds any (one run read
    K2 at a third of its event time), so the largest of ``tries`` is
    kept."""
    return max(sum(us for _, us in device_events(fn, reps))
               for _ in range(tries)) / reps / 1e3


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, err, fn, plain_fn, nbytes, ops,
          path, library_ms=None, counter=None) -> dict:
    """A kernel's line: ``ms`` / ``plain_ms`` from CUDA events around a
    loop of calls (host launch gaps included), ``device_ms`` /
    ``plain_device_ms`` from the profiler (device work only).  ``counter``
    names the launch counter (:func:`kernel_modules`) where ``name`` less a
    ``_t<T>`` suffix does not."""
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain_fn), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                device_ms=device_ms(fn), plain_device_ms=device_ms(plain_fn),
                path=path, counter=counter or re.sub(r"_t\d+$", "", name))


def timing(e: dict) -> str:
    return (f"kernel {e['ms']:.4f} ms ({e['device_ms']:.4f} on the device), "
            f"plain {e['plain_ms']:.4f} ms ({e['plain_device_ms']:.4f}), "
            f"bound {e['bound_ms']:.6f} ms ({e['bound_by']})")


def bits_equal(a, b) -> bool:
    """Equal bit for bit (+0 and -0 apart, NaN equal to itself)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_batch_independent(name: str, fn, inputs, T: int) -> None:
    """Fail unless two calls of ``fn`` on the T-frame ``inputs`` give the
    same bits, and frames 0, T/2 and T-1 of that call the same bits as a
    call on the frame alone."""
    full = fn(*inputs)
    again = fn(*inputs)
    if not all(bits_equal(a, b) for a, b in zip(full, again)):
        fail(f"{name} T={T}: two calls on the same inputs differ")
    for j in (0, T // 2, T - 1):
        one = fn(*(x[j:j + 1].contiguous() for x in inputs))
        if not all(bits_equal(a[j:j + 1], b) for a, b in zip(full, one)):
            fail(f"{name}: frame {j} of the T={T} call differs from the "
                 f"T=1 call on the same inputs")


def kernel_modules() -> dict:
    """Each kernel's launch counter: (module, attribute)."""
    from vaudio_torch.ops import (audio_kernel, pool_kernel, spectrum_kernel,
                                  vision_kernel)
    return {"mip_pool_u8": (pool_kernel, "launches"),
            "mip_pool_planes_u8": (pool_kernel, "planar_launches"),
            "mip_pool_yuv420_u8": (pool_kernel, "yuv_launches"),
            "hann_peak_weighted_sum": (spectrum_kernel, "launches"),
            "vision_stats": (vision_kernel, "launches"),
            "agc_overlap_add": (audio_kernel, "launches")}


def reset_counts() -> None:
    for mod, attr in kernel_modules().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_modules().items()}


def clip_slice(clip, start: int, end: int):
    """Frames start:end of an RGB clip or of a dict of YUV planes."""
    if isinstance(clip, dict):
        return {k: v[start:end] for k, v in clip.items()}
    return clip[start:end]


def crop256(clip):
    """The top-left 256x256 of a clip (for YUV: Y 256^2, U and V 128^2)."""
    if isinstance(clip, dict):
        return {k: np.ascontiguousarray(v[:, :s, :s]) for k, v, s in
                ((k, v, 256 if k == "y" else 128) for k, v in clip.items())}
    return np.ascontiguousarray(clip[:, :256, :256])


def as_source(clip):
    """A clip as a live source: the RGB array, or a list of per-frame
    dicts of YUV planes."""
    if isinstance(clip, dict):
        return [{k: v[i] for k, v in clip.items()}
                for i in range(len(clip["y"]))]
    return clip


def pool_of(clip) -> str:
    """The K1 entry a clip's frames go through."""
    return "mip_pool_yuv420_u8" if isinstance(clip, dict) else "mip_pool_u8"


def live_config():
    from vaudio_torch.config import AuralizerConfig
    return AuralizerConfig(sample_rate=48000.0, channels=2, use_pallas=True,
                           use_pallas_vision=True,
                           ring_buffer_frames=LIVE_T + 8)


def phase_env() -> str:
    from vaudio_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc[-1]} | {smi}")
    return smi


def phase_build(smi: str) -> None:
    from vaudio_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log = (path.parent / "nvcc.log").read_text().splitlines()
    regs = [ln.split("ptxas info    : ")[-1] for ln in log if "Used" in ln]
    say(f"build: {time.perf_counter() - t0:.2f} s ({smi}) -> {path} | "
        + " ; ".join(regs))


def share(e: dict) -> str:
    return f"share of the bound {100 * e['bound_ms'] / e['device_ms']:.1f}%"


# Integer and f32 operations per K1 output texel beyond the block sum: the
# epilogue (2); the YUV entry's per RGB texel (three outputs): Y's epilogue
# and offset (3), U's and V's (6), BT.601 (8) and the clamps (6).
K1_EPILOGUE_OPS = 2
K1_YUV_TEXEL_OPS = 23


def phase_k1(smi: str) -> list:
    """K1's interleaved entry on 1080p u8 RGB at T = 1, 8 and 64 (the live
    per-frame step, the live chunks of 8, the offline chunk): integer block
    sums exact and the 1/255 mips equal to the plain version bit for bit;
    an odd crop at levels 1 and 7; both times, the bound and its share."""
    from vaudio_torch.ops import pool_kernel as pk
    H, W = 1080, 1920
    gen = torch.Generator(device="cuda").manual_seed(0)
    every = torch.randint(0, 256, (CHUNK_T, H, W, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    odd = every[:3, :1079, :1917].contiguous()
    for level in (1, 7):
        if not bits_equal(pk.mip_pool(odd, level, 1.0 / 255.0),
                          pk.mip_pool_plain(odd.permute(0, 3, 1, 2), level,
                                            1.0 / 255.0)):
            fail(f"K1 odd crop 3x1079x1917 level {level} differs from the "
                 f"plain version")
    entries = []
    for T, path in ((1, "live_frame"), (LIVE_CHUNK, "live_chunk"),
                    (CHUNK_T, "offline")):
        frames = every[:T].contiguous()
        planes = frames.permute(0, 3, 1, 2)
        # scale = 4^l makes gain 1: the outputs ARE the integer block sums.
        k2 = float(4 ** MIP)
        if not torch.equal(pk.mip_pool(frames, MIP, scale=k2),
                           pk.mip_pool_plain(planes, MIP, scale=k2)):
            fail(f"K1 T={T}: integer block sums differ from the plain "
                 f"version")
        got = pk.mip_pool(frames, MIP, scale=1.0 / 255.0)
        ref = pk.mip_pool_plain(planes, MIP, scale=1.0 / 255.0)
        torch.cuda.synchronize()
        if got.shape != (T, 3, H >> MIP, W >> MIP):
            fail(f"K1 output shape {tuple(got.shape)}")
        if not bits_equal(got, ref):
            fail(f"K1 T={T}: the 1/255 mips differ from the plain version "
                 f"by {float((got - ref).abs().max()):.3e}")
        err = float((got - ref).abs().max())
        out_n = T * 3 * (H >> MIP) * (W >> MIP)
        e = entry("mip_pool_u8" + ("" if T == LIVE_CHUNK else f"_t{T}"),
                  "vaudio_torch/csrc/pool_kernel.cu",
                  "vaudio/ops/pool_kernel.py:130", err,
                  lambda: pk.mip_pool(frames, MIP, scale=1.0 / 255.0),
                  lambda: pk.mip_pool_plain(planes, MIP, 1.0 / 255.0),
                  nbytes=T * H * W * 3 + 4 * out_n,
                  ops=T * H * W * 3 + K1_EPILOGUE_OPS * out_n, path=path)
        say(f"K1 mip_pool u8 [{T},{H},{W},3] mip {MIP}: sums exact, equal "
            f"to the plain version bit for bit; odd crop 3x1079x1917 at "
            f"levels 1 and 7 equal; {timing(e)}; {share(e)} ({smi})")
        entries.append(e)
    # The OrthoModes route (models.orthomodes.pixel_mip): mip 5, 1/255.
    for T, path in ((1, "ortho_live_frame"), (CHUNK_T, "ortho_offline")):
        frames = every[:T].contiguous()
        planes = frames.permute(0, 3, 1, 2)
        k2 = float(4 ** ORTHO_MIP)
        if not torch.equal(pk.mip_pool(frames, ORTHO_MIP, scale=k2),
                           pk.mip_pool_plain(planes, ORTHO_MIP, scale=k2)):
            fail(f"K1 mip {ORTHO_MIP} T={T}: integer block sums differ")
        got = pk.mip_pool(frames, ORTHO_MIP, scale=1.0 / 255.0)
        ref = pk.mip_pool_plain(planes, ORTHO_MIP, scale=1.0 / 255.0)
        if got.shape != (T, 3, H >> ORTHO_MIP, W >> ORTHO_MIP) or \
                not bits_equal(got, ref):
            fail(f"K1 mip {ORTHO_MIP} T={T}: differs from the plain "
                 f"version (shape {tuple(got.shape)})")
        out_n = T * 3 * (H >> ORTHO_MIP) * (W >> ORTHO_MIP)
        e = entry(f"mip_pool_u8_l{ORTHO_MIP}_t{T}",
                  "vaudio_torch/csrc/pool_kernel.cu",
                  "vaudio/ops/pool_kernel.py:130",
                  float((got - ref).abs().max()),
                  lambda: pk.mip_pool(frames, ORTHO_MIP, scale=1.0 / 255.0),
                  lambda: pk.mip_pool_plain(planes, ORTHO_MIP, 1.0 / 255.0),
                  nbytes=T * H * W * 3 + 4 * out_n,
                  ops=T * H * W * 3 + K1_EPILOGUE_OPS * out_n, path=path,
                  counter="mip_pool_u8")
        say(f"K1 mip_pool u8 [{T},{H},{W},3] mip {ORTHO_MIP} (the OrthoModes "
            f"route): sums exact, equal to the plain version bit for bit; "
            f"{timing(e)}; {share(e)} ({smi})")
        entries.append(e)
    return entries


# The studio-swing scales of the YUV mips (ops/pool_kernel.yuv420_scales).
Y_SCALE, C_SCALE = 1.0 / 219.0, 1.0 / 224.0


def k1_planar_check(name: str, planes, level: int, scale: float) -> float:
    """Fail unless K1's planar entry gives the plain version's integer
    block sums exactly (scale 4^l) and its mips at ``scale`` bit for bit;
    returns the max abs error."""
    from vaudio_torch.ops import pool_kernel as pk
    k = float(4 ** level)
    if not torch.equal(pk.mip_pool_planes(planes, level, k),
                       pk.mip_pool_plain(planes, level, k)):
        fail(f"{name}: integer block sums differ from the plain version")
    got = pk.mip_pool_planes(planes, level, scale)
    ref = pk.mip_pool_plain(planes, level, scale)
    if not bits_equal(got, ref):
        fail(f"{name}: differs from the plain version (shape "
             f"{tuple(got.shape)})")
    return float((got - ref).abs().max())


def k1_yuv_check(name: str, y, u, v, level: int) -> None:
    """Fail unless K1's YUV entry equals its plain version bit for bit."""
    from vaudio_torch.ops import pool_kernel as pk
    got = pk.mip_pool_yuv420(y, u, v, level)
    ref = pk.mip_pool_yuv420_plain(y, u, v, level)
    if not bits_equal(got, ref):
        fail(f"{name}: differs from the plain version (shape "
             f"{tuple(got.shape)}, max {float((got - ref).abs().max()):.3e})")


def phase_k1_planar(smi: str) -> list:
    """K1's planar and YUV entries on a 1080p YUV 4:2:0 chunk, Y
    [64,1080,1920] at mip 3 and U, V [64,540,960] at mip 2.  The planar
    entry: sums exact and the studio-swing mips equal to the plain version,
    on each plane and on an odd crop at levels 1 and 7.  The YUV entry (one
    launch to the clamped RGB mips): equal to its plain version bit for
    bit, on the chunk and on an odd crop at levels 1 (unpooled chroma) to
    7.  Both: frames 0, T/2, T-1 against T=1 calls and two calls, bit for
    bit.  Timed at T=64 (the offline chunk) and T=1 (the live per-frame
    step): one YUV dispatch through the YUV entry (the listed entries) and
    the planar entry on the Y planes alone (printed; no main path launches
    it since the YUV entry took the YUV dispatch)."""
    from vaudio_torch.ops import pool_kernel as pk
    gen = torch.Generator(device="cuda").manual_seed(1)

    def planes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    T, H, W = CHUNK_T, 1080, 1920
    y, u, v = planes(T, H, W), planes(T, H // 2, W // 2), \
        planes(T, H // 2, W // 2)
    err = max(k1_planar_check("K1 planar Y", y, MIP, Y_SCALE),
              k1_planar_check("K1 planar U", u, MIP - 1, C_SCALE),
              k1_planar_check("K1 planar V", v, MIP - 1, C_SCALE))
    odd = y[:3, :1079, :1917].contiguous()
    odd_c = [x[:3, :540, :959].contiguous() for x in (u, v)]
    for level in (1, 7):
        k1_planar_check(f"K1 planar odd crop level {level}", odd, level,
                        Y_SCALE)
    k1_yuv_check("K1 YUV", y, u, v, MIP)
    for level in range(1, 8):
        k1_yuv_check(f"K1 YUV odd crop 3x1079x1917 level {level}", odd,
                     *odd_c, level)
    check_batch_independent(
        "K1 planar Y", lambda x: (pk.mip_pool_planes(x, MIP, Y_SCALE),),
        (y,), T)
    check_batch_independent(
        "K1 YUV", lambda *p: (pk.mip_pool_yuv420(*p, MIP),), (y, u, v), T)
    entries = []
    for n, path in ((T, "offline_yuv"), (1, "live_yuv_frame")):
        yn, un, vn = (x[:n].contiguous() for x in (y, u, v))
        out_n = n * (H >> MIP) * (W >> MIP)        # texels of one plane
        planar = entry(
            "mip_pool_planes_u8", "vaudio_torch/csrc/pool_kernel.cu",
            "vaudio/ops/pool_kernel.py:130", err,
            lambda: pk.mip_pool_planes(yn, MIP, Y_SCALE),
            lambda: pk.mip_pool_plain(yn, MIP, Y_SCALE),
            nbytes=n * H * W + 4 * out_n,
            ops=n * H * W + K1_EPILOGUE_OPS * out_n, path=path)
        say(f"K1 mip_pool_planes u8 Y [{n},{H},{W}] mip {MIP}: sums exact, "
            f"U and V at mip {MIP - 1} too, equal bit for bit, max_abs_err "
            f"{err:.3e}; odd crop 3x1079x1917 at levels 1 and 7; frames 0, "
            f"T/2, T-1 equal to T=1 calls and two calls equal, bit for bit; "
            f"{timing(planar)}; {share(planar)} ({smi})")
        fused = entry(
            "mip_pool_yuv420_u8" + ("" if n == T else f"_t{n}"),
            "vaudio_torch/csrc/pool_kernel.cu",
            "vaudio/ops/pool_kernel.py:130", 0.0,
            lambda: pk.mip_pool_yuv420(yn, un, vn, MIP),
            lambda: pk.mip_pool_yuv420_plain(yn, un, vn, MIP),
            nbytes=n * H * W * 3 // 2 + 4 * 3 * out_n,
            ops=n * H * W * 3 // 2 + K1_YUV_TEXEL_OPS * out_n, path=path)
        say(f"K1 mip_pool_yuv420 u8 one YUV 4:2:0 dispatch T={n}: Y "
            f"[{n},{H},{W}] mip {MIP} + U,V [{n},{H // 2},{W // 2}] mip "
            f"{MIP - 1} in 1 launch to the clamped RGB mips "
            f"[{n},3,{H >> MIP},{W >> MIP}]: equal to the plain version bit "
            f"for bit, and on the odd crop at levels 1-7; frames 0, T/2, T-1 "
            f"equal to T=1 calls and two calls equal, bit for bit; "
            f"{timing(fused)}; {share(fused)} ({smi})")
        entries.append(fused)
    return entries


def phase_k2(smi: str) -> list:
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.ops import spectrum_kernel as sk
    cfg = AuralizerConfig(sample_rate=48000.0)
    rng = np.random.default_rng(0)
    NP, F = 496, cfg.num_bins
    freqs = torch.as_tensor(cfg.bin_frequencies(), device="cuda")
    entries = []
    for T, K in ((CHUNK_T, 2), (CHUNK_T, 4), (LIVE_CHUNK, 4), (1, 4)):
        pf = torch.as_tensor(rng.uniform(20, 20000, (T, NP)).astype(
            np.float32), device="cuda")
        scale = torch.as_tensor((rng.choice([1.0, 0.2], (T, NP))
                                 / cfg.bin_width).astype(np.float32),
                                device="cuda")
        w = torch.as_tensor(rng.normal(0, 0.1, (T, NP, K)).astype(
            np.float32), device="cuda")
        got = sk.hann_peak_weighted_sum(freqs, pf, scale, w)
        ref = sk.hann_peak_weighted_sum_plain(freqs, pf, scale, w)
        torch.cuda.synchronize()
        if got.shape != (T, F, K):
            fail(f"K2 output shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        if not err <= 1e-5:
            fail(f"K2 T={T} K={K} differs from the plain version by "
                 f"{err:.3e}")
        bits = ""
        if T == CHUNK_T:
            check_batch_independent(
                f"K2 K={K}", lambda *a: (sk.hann_peak_weighted_sum(
                    freqs, *a),), (pf, scale, w), T)
            bits = "; frames 0, T/2, T-1 equal to T=1 calls and two calls "
            bits += "equal, bit for bit"
        e = entry("hann_peak_weighted_sum" + ("" if T == CHUNK_T
                                              else f"_t{T}"),
                  "vaudio_torch/csrc/spectrum_kernel.cu",
                  "vaudio/ops/spectrum_kernel.py:"
                  + ("71" if T == 1 else "142"), err,
                  lambda: sk.hann_peak_weighted_sum(freqs, pf, scale, w),
                  lambda: sk.hann_peak_weighted_sum_plain(freqs, pf, scale,
                                                          w),
                  nbytes=4 * (F + T * NP * (2 + K) + T * F * K),
                  ops=T * F * NP * (K2_PEAK_OPS + 2 * K),
                  path={1: "live_frame", LIVE_CHUNK: "live_chunk"}.get(
                      T, "offline"))
        say(f"K2 hann_peak_weighted_sum T={T} F={F} NP={NP} K={K}: "
            f"max_abs_err {err:.3e}{bits}; {timing(e)} ({smi})")
        if K == 4:              # the stereo paths' shape
            entries.append(e)
    return entries


def offline_config():
    from vaudio_torch.config import AuralizerConfig
    return AuralizerConfig(sample_rate=48000.0, channels=2)


def crop_card_vs_cpu(label: str, clip, cfg, run=None, **kw) -> str:
    """The 256x256 crop of ``clip`` through ``run`` (the chunked path by
    default) on the card and on the CPU: fail unless the hue sequences are
    equal, moved, and the PCM is within 1e-4; returns the summary."""
    from vaudio_torch.runtime.chunked import run_offline_batched
    run = run or run_offline_batched
    crop = crop256(clip)
    a_gpu, _, d_gpu = run(crop, cfg, debug=True, device="cuda", **kw)
    a_cpu, _, d_cpu = run(crop, cfg, debug=True, device="cpu", **kw)
    hues_cpu = d_cpu["hues"]
    if not torch.equal(d_gpu["hues"].cpu(), hues_cpu):
        fail(f"{label} 256x256 crop: hue sequences differ card vs CPU")
    if len(torch.unique(hues_cpu)) < 10:
        fail(f"{label} 256x256 crop: the hues did not move")
    err = float((a_gpu.cpu() - a_cpu).abs().max())
    if not err <= 1e-4:
        fail(f"{label} 256x256 crop: PCM card vs CPU differs by {err:.3e}")
    return (f"256x256 crop card vs CPU: hues equal "
            f"({len(torch.unique(hues_cpu))} distinct), PCM max diff "
            f"{err:.3e}")


def phase_offline(clip, smi: str):
    """``Auralizer.sonify`` on the card, from host and from device frames,
    with the launch counts of the host run; RGB frames or a YUV dict.
    Returns (launches, ms/frame from host frames)."""
    from vaudio_torch.api import Auralizer
    cfg = offline_config()
    yuv = isinstance(clip, dict)
    what = "YUV 4:2:0 " if yuv else ""
    T = len(clip["y"] if yuv else clip)
    aur = Auralizer(config=cfg, device="cuda")
    aur.sonify(clip)            # warm-up at the chunk's shape (cuFFT plans,
    torch.cuda.synchronize()    # the caching allocator's blocks)

    reset_counts()
    t0 = time.perf_counter()
    audio = aur.sonify(clip)                        # returns host numpy
    wall = time.perf_counter() - t0
    launches = read_counts()
    if audio.shape != (T * cfg.hop_size, 2):
        fail(f"offline PCM shape {audio.shape}")
    if not np.all(np.isfinite(audio)) or not np.any(audio != 0):
        fail("offline PCM is not finite or all zero")
    pool, chunks = pool_of(clip), -(-T // CHUNK_T)
    if min(launches[pool], launches["hann_peak_weighted_sum"]) < 1:
        fail(f"a kernel of the offline path never launched: {launches}")
    if launches["agc_overlap_add"] != chunks:
        fail(f"offline: K4 launched {launches['agc_overlap_add']} times for "
             f"{T} frames in chunks of {CHUNK_T}")
    if yuv and (launches[pool] != chunks or launches["mip_pool_u8"]
                or launches["mip_pool_planes_u8"]):
        fail(f"offline YUV: not exactly 1 K1 launch a chunk (the YUV "
             f"entry's), or another K1 entry launched: {launches}")
    t1 = time.perf_counter()
    if yuv:                                         # pageable copies
        dev_clip = {k: torch.as_tensor(v, device="cuda")
                    for k, v in clip.items()}
        nbytes = sum(v.nbytes for v in clip.values())
    else:
        dev_clip = torch.as_tensor(clip, device="cuda")
        nbytes = clip.nbytes
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t1
    say(f"offline: host-to-device copy of {T} {what}frames from pageable "
        f"memory: {nbytes / 1e6:.1f} MB in {1e3 * h2d:.2f} ms, "
        f"{nbytes / h2d / 1e9:.2f} GB/s ({smi})")
    t1 = time.perf_counter()
    aur.sonify(dev_clip)
    wall_dev = time.perf_counter() - t1
    say(f"offline: Auralizer.sonify {T} {what}frames 1080x1920 stereo "
        f"48 kHz chunk {CHUNK_T}: {1e3 * wall / T:.3f} ms/frame from host "
        f"frames, {1e3 * wall_dev / T:.3f} ms/frame from device frames "
        f"({smi}); launches {launches}")
    say(f"offline: {what}" + crop_card_vs_cpu(f"offline {what}", clip, cfg))
    return launches, 1e3 * wall / T


def phase_k3(frames: np.ndarray, smi: str) -> list:
    from vaudio_torch.ops import pool_kernel
    from vaudio_torch.ops import vision_kernel as vk
    cfg = live_config()
    mips = pool_kernel.mip_pool(torch.as_tensor(frames[:CHUNK_T],
                                                device="cuda"),
                                MIP, scale=1.0 / 255.0)
    entries = []
    for T in (CHUNK_T, LIVE_CHUNK, 1):
        m = mips[:T].contiguous()
        hist, grads = vk.vision_stats(m, cfg)
        ref_h, ref_g = vk.vision_stats_plain(m, cfg)
        torch.cuda.synchronize()
        hm, wm = m.shape[-2:]
        if hist.shape != (T, 16, 360) or grads.shape != (T, 16, 4):
            fail(f"K3 output shapes {tuple(hist.shape)} {tuple(grads.shape)}")
        if not torch.equal(hist, ref_h):
            moved = float((hist - ref_h).abs().sum())
            kept = torch.equal(hist.sum(-1), ref_h.sum(-1))
            fail(f"K3 T={T} histogram differs from the plain version: L1 "
                 f"{moved}, counts per cell conserved: {kept}")
        if float(hist.sum()) <= 0:
            fail("K3 histogram is empty")
        if not torch.allclose(grads, ref_g, rtol=1e-5, atol=1e-6):
            fail(f"K3 T={T} statistics differ from the plain version by "
                 f"{float((grads - ref_g).abs().max()):.3e}")
        err = float((grads - ref_g).abs().max())
        bits = ""
        if T == CHUNK_T:
            check_batch_independent(
                "K3", lambda x: vk.vision_stats(x, cfg), (m,), T)
            bits = "; frames 0, T/2, T-1 equal to T=1 calls and two calls "
            bits += "equal, bit for bit"
        e = entry("vision_stats" + ("_t1" if T == 1 else ""),
                  "vaudio_torch/csrc/vision_kernel.cu",
                  "vaudio/ops/vision_kernel.py:"
                  + ("313" if T == 1 else "352"), err,
                  lambda: vk.vision_stats(m, cfg),
                  lambda: vk.vision_stats_plain(m, cfg),
                  nbytes=4 * T * (3 * hm * wm + 16 * (360 + 4)),
                  ops=T * hm * wm * K3_PIXEL_OPS,
                  path="live_frame" if T == 1 else "live_chunk")
        say(f"K3 vision_stats T={T} mip {hm}x{wm}: counts exact, "
            f"statistics max_abs_err {err:.3e}{bits}; {timing(e)} ({smi})")
        if T != CHUNK_T:         # the live paths' shapes
            entries.append(e)
    return entries


def k4_err(name: str, got, ref) -> float:
    """Fail unless pcm and tail are within 1e-6 and the running max (one,
    or one a stream) within rtol 1e-6 (NaN where the reference has NaN);
    returns the max abs error
    of pcm and tail.  The plain version on the card divides by a Python
    scalar, which CUDA turns into a reciprocal multiply (1 ulp of the
    norm), so the kernel is exact against it only most of the time."""
    err = 0.0
    for g, r in zip(got[:2], ref[:2]):
        if g.shape != r.shape or not torch.equal(g.isnan(), r.isnan()):
            fail(f"{name}: shape or NaN positions differ")
        err = max(err, float((g - r).nan_to_num().abs().max()))
    gm, rm = got[2].double().cpu(), ref[2].double().cpu()  # f32[] or [S]
    same = (gm == rm) | (gm.isnan() & rm.isnan())
    rel = float(torch.where(same, 0.0, (gm - rm).abs() / rm.abs()).max())
    if not err <= 1e-6 or not rel <= 1e-6:
        fail(f"{name}: differs from the plain version by {err:.3e} "
             f"(running max rel {rel:.3e})")
    return err


def phase_k4(smi: str) -> list:
    """K4 in both op orders (the frame order chained frame by frame, as
    frame_step calls it, and at T frames in one call, as the OrthoModes
    chunk step calls it), mono and stereo, at T = 1, 8 and 64 (and nfft
    8192, a hop that is not a multiple of 4, and T = 300, beyond one block
    of the kernel's frame loop) against the plain version on the card and
    on the CPU; the edge frames; T=64 calls in the chunk order and in the
    frame order equal to 64 chained T=1 calls and to a second call; one
    device kernel per wrapper call.  Entries at the main paths' shapes: T=1
    frame order (``agc_overlap_add``, the live per-frame step), T=8 and
    T=64 chunk order (the live chunks and the offline chunk), and the
    frame order at T=8 and T=64, mono (the OrthoModes live chunks and
    offline block)."""
    from torch.profiler import ProfilerActivity, profile
    from torch_frames import k4_args, k4_chained, k4_edge_frames, k4_forms

    from vaudio_torch.dsp.core import hann_window_norm
    from vaudio_torch.ops import audio_kernel as ak
    rng = np.random.default_rng(0)
    exact = total = 0
    for nfft, Cs, Ts in ((4096, (1, 2), (1, 8, 64)), (8192, (2,), (8,)),
                         (1000, (2,), (8,)), (4096, (2,), (300,))):
        for C in Cs:
            for T in Ts:
                for order in ("frame", "chunk", "frames"):
                    fn, plain, run = k4_forms(order)
                    args = k4_args(rng, T, C, nfft, "cuda")
                    got = run(fn, *args)
                    ref = run(plain, *args)
                    torch.cuda.synchronize()
                    name = f"K4 {order} order C={C} T={T} nfft={nfft}"
                    k4_err(name, got, ref)
                    k4_err(name + " (CPU plain)", [x.cpu() for x in got],
                           run(plain, *(x.cpu() for x in args)))
                    exact += all(bits_equal(g, r) for g, r in zip(got, ref))
                    total += 1
    window = torch.as_tensor(hann_window_norm(4096), device="cuda")
    sig = torch.as_tensor(k4_edge_frames(rng), device="cuda")
    tail = torch.zeros((2, 4096), device="cuda")
    for rmax in (1.0, 1e-30, float("inf"), float("nan"), -1.0):
        scal = [torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in (rmax, 0.5, 0.2)]
        for order in ("frame", "chunk", "frames"):
            fn, plain, run = k4_forms(order)
            got = run(fn, sig, tail, window, *scal)
            k4_err(f"K4 edge frames {order} order running max {rmax}", got,
                   run(plain, sig, tail, window, *scal))
            if not bool(torch.isfinite(got[0]).all()):
                fail(f"K4 edge frames {order}: pcm not finite")
    for C in (1, 2):
        args = k4_args(rng, CHUNK_T, C, device="cuda")
        for fn, one in ((ak.agc_overlap_add_chunk, ak.agc_overlap_add_chunk),
                        (ak.agc_overlap_add_frames, k4_forms("frame")[0])):
            full = fn(*args)
            if not all(bits_equal(a, b) for a, b in zip(full, fn(*args))):
                fail(f"K4 {fn.__name__} T={CHUNK_T}: two calls differ")
            if not all(bits_equal(a, b) for a, b in
                       zip(k4_chained(one, *args), full)):
                fail(f"K4 {fn.__name__} C={C} T={CHUNK_T}: differs from "
                     f"{CHUNK_T} chained T=1 calls")
    # The profiler can lose device records, never add any: every recorded
    # kernel must be K4's, at most two a wrapper call.
    one = [args[0][0]] + args[1:]
    for what, call in (("chunk", lambda: ak.agc_overlap_add_chunk(*args)),
                       ("frame", lambda: ak.agc_overlap_add(*one)),
                       ("frames", lambda: ak.agc_overlap_add_frames(*args))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not (1 <= len(kernels) <= 20
                and all("agc_overlap_add" in k for k in kernels)):
            fail(f"K4 {what} order: device kernels of 10 calls: {kernels}")
    say(f"K4 agc_overlap_add: {total} shapes x orders (C=1,2; T=1,8,64,300; "
        f"nfft 4096, 8192, 1000) within 1e-6 of the plain version on the "
        f"card and on the CPU, {exact} of them bit for bit on the card; "
        f"edge frames (zero, NaN, +-inf, FLT_MAX, denormal; running max 1, "
        f"1e-30, inf, NaN, -1) within 1e-6 and finite; T={CHUNK_T} equal to "
        f"{CHUNK_T} chained T=1 calls and to a second call, bit for bit, in "
        f"the chunk order and in the frame order at T frames (mono and "
        f"stereo); {len(kernels) / 10:g} device kernels per call ({smi})")

    entries = []
    # The OrthoModes chunk step's tail is mono, in the frame order at T.
    for T, order, C, path in ((1, "frame", 2, "live_frame"),
                              (LIVE_CHUNK, "chunk", 2, "live_chunk"),
                              (CHUNK_T, "chunk", 2, "offline"),
                              (LIVE_CHUNK, "frames", 1, "ortho_live_chunk"),
                              (CHUNK_T, "frames", 1, "ortho_offline")):
        args = k4_args(rng, T, C, device="cuda")
        if T == 1:       # the per-frame wrapper, as frame_step calls it
            one = [args[0][0]] + args[1:]
            fn = lambda: ak.agc_overlap_add(*one)               # noqa: E731
            plain_fn = lambda: ak.agc_overlap_add_plain(*one)   # noqa: E731
        else:
            fn, plain_fn = (functools.partial(f, *args)
                            for f in k4_forms(order)[:2])
        err = k4_err(f"K4 {order} order T={T}", fn(), plain_fn())
        nfft = 4096
        hop = nfft // 2
        # Read once: the signals, the tail's second half (all the kernel
        # and the function read of it), the window and three scalars;
        # written once: pcm, the new tail and the running max.
        e = entry("agc_overlap_add" + ("_frames" if order == "frames"
                                       else "")
                  + ("" if T == 1 else f"_t{T}"),
                  "vaudio_torch/csrc/audio_kernel.cu",
                  "vaudio/ops/audio_kernel.py:70", err, fn, plain_fn,
                  nbytes=4 * (T * C * nfft + C * hop + nfft + 3
                              + T * C * hop + C * nfft + 1),
                  ops=T * (6 * C * nfft + C * hop), path=path,
                  counter="agc_overlap_add")
        say(f"K4 agc_overlap_add {order} order T={T} "
            f"{'stereo' if C == 2 else 'mono'} nfft={nfft}: max_abs_err "
            f"{err:.3e}; {timing(e)} ({smi})")
        entries.append(e)
    return entries


def phase_live(frames, smi: str):
    """The live stream per frame and in chunks on RGB frames or a YUV dict:
    launch counts, PCM equal to the offline run on the card, the 256x256
    crop card vs CPU.  Returns (counts by path, ms/frame by path)."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.runtime import chunked, step
    cfg = live_config()
    yuv = isinstance(frames, dict)
    what = "YUV 4:2:0 " if yuv else ""
    clip = clip_slice(frames, 0, LIVE_T)
    for chunk in (1, LIVE_CHUNK):                   # warm-up
        Auralizer(source=as_source(clip_slice(frames, 0, LIVE_CHUNK)),
                  config=cfg, device="cuda",
                  chunk_frames=chunk).run_until_exhausted(timeout=300)
    torch.cuda.synchronize()
    counts, walls = {}, {}
    pool = pool_of(frames)
    for chunk, path in ((1, "live_frame"), (LIVE_CHUNK, "live_chunk")):
        path = path.replace("live", "live_yuv") if yuv else path
        aur = Auralizer(source=as_source(clip), config=cfg, device="cuda",
                        chunk_frames=chunk)
        reset_counts()
        t0 = time.perf_counter()
        aur.run_until_exhausted(timeout=300)
        wall = time.perf_counter() - t0
        counts[path] = launches = read_counts()
        walls[path] = 1e3 * wall / LIVE_T
        m = aur.metrics
        got = aur.pull(LIVE_T * cfg.hop_size * cfg.channels)
        need = [pool, "hann_peak_weighted_sum", "vision_stats",
                "agc_overlap_add"]
        if min(launches[k] for k in need) < 1:
            fail(f"live {what}chunk_frames={chunk}: a kernel of the path "
                 f"never launched: {launches}")
        if launches["agc_overlap_add"] != LIVE_T // chunk:
            fail(f"live {what}chunk_frames={chunk}: K4 launched "
                 f"{launches['agc_overlap_add']} times in {LIVE_T} frames")
        if yuv and (launches[pool] != m["dispatches"]
                    or launches["mip_pool_u8"]
                    or launches["mip_pool_planes_u8"]):
            fail(f"live YUV chunk_frames={chunk}: not exactly 1 K1 launch a "
                 f"dispatch (the YUV entry's), or another K1 entry "
                 f"launched: {launches}, {m['dispatches']} dispatches")
        if m["frames_processed"] != LIVE_T or m["dropped_frames"]:
            fail(f"live {what}chunk_frames={chunk}: {m}")
        # The stream dispatches whole chunks and single-steps the rest.
        main = 0 if chunk == 1 else LIVE_T - LIVE_T % chunk
        ref, carry = torch.zeros((0, cfg.channels), device="cuda"), None
        if main:
            ref, carry, _ = chunked.run_offline_batched(
                clip_slice(clip, 0, main), cfg, chunk=chunk, device="cuda")
        if main < LIVE_T:
            rest, _, _ = step.run_offline(clip_slice(clip, main, LIVE_T),
                                          cfg, carry=carry, device="cuda")
            ref = torch.cat([ref, rest])
        if not np.array_equal(got, ref.cpu().numpy().reshape(-1)):
            fail(f"live {what}chunk_frames={chunk}: the pulled PCM differs "
                 f"from the offline run on the card by "
                 f"{np.abs(got - ref.cpu().numpy().reshape(-1)).max():.3e}")
        if not np.any(got != 0):
            fail(f"live {what}chunk_frames={chunk}: silent")
        say(f"live: Auralizer(...).run_until_exhausted {LIVE_T} {what}"
            f"frames 1080x1920 stereo 48 kHz chunk_frames={chunk}: "
            f"{walls[path]:.3f} ms/frame, latency p50 "
            f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms "
            f"(unpaced, pipeline depth 4); PCM equal to the offline run on "
            f"the card; launches {launches} in {m['dispatches']} dispatches "
            f"({smi})")

    runs = (("per frame", step.run_offline, {}),
            ("chunked", chunked.run_offline_batched, {"chunk": LIVE_CHUNK}))
    for label, run, kw in runs:
        say(f"live: {what}{label} " + crop_card_vs_cpu(
            f"live {what}{label}", clip, cfg, run, **kw))
    return counts, walls


# The AuralizerConfig flags outside the default path (quantize_mips_int8
# acts only with quantize_mips).
FLAGS = (("quantize_mips", dict(quantize_mips=True)),
         ("quantize_mips_int8", dict(quantize_mips=True,
                                     quantize_mips_int8=True)),
         ("linear_cell_grads=False", dict(linear_cell_grads=False)),
         ("use_phase_lut", dict(use_phase_lut=True)),
         ("use_matmul_ema", dict(use_matmul_ema=True)),
         ("use_matmul_irfft", dict(use_matmul_irfft=True)))
FLAG_CROP_T = 32                 # frames of each flag's 256x256 crop


def phase_flags(frames: np.ndarray, smi: str) -> None:
    """Each flag offline on the card (``Auralizer.sonify``, chunk 64)
    beside the default config in the same call, its launch counts, and
    its 256x256 crop card vs CPU; the LUT's PCM bit-equal to the default's
    (cumsum phases); the dense irfft's time beside torch.fft.irfft's."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.dsp.core import irfft_from_half, irfft_from_half_dense
    base = offline_config()
    T = len(frames)
    pcm = {}
    for name, flags in (("default", {}),) + FLAGS:
        cfg = dataclasses.replace(base, **flags)
        aur = Auralizer(config=cfg, device="cuda")
        aur.sonify(frames)                          # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        pcm[name] = aur.sonify(frames)
        ms = 1e3 * (time.perf_counter() - t0) / T
        launches = read_counts()
        if (pcm[name].shape != (T * cfg.hop_size, 2)
                or not np.all(np.isfinite(pcm[name]))
                or not np.any(pcm[name] != 0)):
            fail(f"flag {name}: PCM not finite, silent or of shape "
                 f"{pcm[name].shape}")
        if min(launches["hann_peak_weighted_sum"],
               launches["agc_overlap_add"]) < 1:
            fail(f"flag {name}: a kernel of the path never launched: "
                 f"{launches}")
        crop = crop_card_vs_cpu(f"flag {name}", frames[:FLAG_CROP_T], cfg)
        say(f"flags: {name}: Auralizer.sonify {T} frames 1080x1920 stereo "
            f"48 kHz chunk {CHUNK_T}: {ms:.3f} ms/frame from host frames; "
            f"launches {launches}; {FLAG_CROP_T}-frame {crop} ({smi})")
    if not np.array_equal(pcm["use_phase_lut"], pcm["default"]):
        fail("use_phase_lut: PCM differs from the default config's on the "
             "card (cumsum phases: the gather must equal the direct path)")
    say("flags: use_phase_lut PCM equal to the default config's, bit for "
        "bit, on the card")
    spec = torch.randn((CHUNK_T, 2, base.num_bins, 2), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    dense, fft = irfft_from_half_dense(spec), irfft_from_half(spec)
    err = float((dense - fft).abs().max() / fft.abs().max())
    if not err <= 1e-5:
        fail(f"dense irfft differs from torch.fft.irfft by {err:.3e} of the "
             f"peak")
    say(f"flags: irfft of [{CHUNK_T},2,{base.num_bins}] -> 4096: dense f32 "
        f"products {cuda_ms(lambda: irfft_from_half_dense(spec)):.4f} ms "
        f"({device_ms(lambda: irfft_from_half_dense(spec)):.4f} on the "
        f"device), torch.fft.irfft {cuda_ms(lambda: irfft_from_half(spec)):.4f}"
        f" ms ({device_ms(lambda: irfft_from_half(spec)):.4f}); max diff "
        f"{err:.2e} of the peak ({smi})")


def phase_debug(frames: np.ndarray, smi: str) -> None:
    """sonify(debug=True) on the card: PCM bit-equal to debug=False, the
    JAX package's shapes; inspect_frame on one 1080p frame: the JAX keys,
    the rotated (wm, hm, 4) maps, finite."""
    from vaudio_torch.api import Auralizer
    cfg = offline_config()
    T = len(frames)
    aur = Auralizer(config=cfg, device="cuda")
    pcm, dbg = aur.sonify(frames, debug=True)
    if not np.array_equal(pcm, aur.sonify(frames)):
        fail("sonify(debug=True): PCM differs from debug=False")
    shapes = {k: v.shape for k, v in dbg.items()}
    want = {"hues": (T, 16), "grads": (T, 16, 4),
            "spectrum": (T, 2, cfg.num_bins, 2)}
    if shapes != want:
        fail(f"sonify(debug=True) shapes {shapes}, expected {want}")
    maps = aur.inspect_frame(frames[0])
    keys = {"hues", "grads", "histogram", "hue_map", "saturation_map",
            "intensity_map", "mip_hsi"}
    hm, wm = 1080 >> MIP, 1920 >> MIP
    if (set(maps) != keys or maps["hue_map"].shape != (wm, hm, 4)
            or maps["mip_hsi"].shape != (hm, wm, 3)
            or not all(np.all(np.isfinite(v)) for v in maps.values())):
        fail(f"inspect_frame: {({k: v.shape for k, v in maps.items()})}")
    say(f"debug: sonify(debug=True) {T} frames: PCM equal to debug=False "
        f"bit for bit, shapes {shapes}; inspect_frame 1080x1920: "
        f"{({k: v.shape for k, v in maps.items()})} ({smi})")


def kind_of(name: str) -> str:
    """The kind of a device event, for the profile's table."""
    for kernel in ("mip_pool_u8", "mip_pool_planes", "mip_pool_yuv420",
                   "hann_peak_weighted_sum", "vision_stats",
                   "agc_overlap_add"):
        if kernel in name:
            return kernel
    if name.startswith("Memcpy"):
        return name.split(" (")[0]                  # Memcpy HtoD / DtoH
    if "fft" in name.lower():
        return "cuFFT"
    if "elementwise" in name or "vectorized" in name:
        return "PyTorch elementwise"
    if "reduce" in name.lower():
        return "PyTorch reductions"
    return "other"


def profiled(run) -> tuple:
    """``run()`` under torch.profiler: (device events by kind: (count, µs),
    the wall clock in ms, synchronised)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, us = rows.get(kind_of(e.name), (0, 0.0))
        rows[kind_of(e.name)] = (n + 1, us + e.time_range.elapsed_us())
    return rows, wall_ms


def profile_line(label: str, rows: dict, wall_ms: float, T: int,
                 dispatches: int, smi: str,
                 shape: str = "1080x1920 stereo") -> str:
    """The profile's line: wall and device busy per frame, the idle share,
    device events per frame, host-to-device copies per dispatch, and the
    events by kind."""
    busy_ms = sum(us for _, us in rows.values()) / 1e3
    if busy_ms <= 0:
        return (f"profile: {label}: torch.profiler recorded no device "
                f"events: not measured")
    table = ", ".join(f"{k} {n / T:.2f}/frame {us / 1e3 / T:.4f} ms"
                      for k, (n, us) in sorted(rows.items(),
                                               key=lambda r: -r[1][1]))
    return (f"profile: {label}, {T} frames {shape}: wall "
            f"{wall_ms / T:.3f} ms/frame, device busy {busy_ms / T:.4f} "
            f"ms/frame ({100 * busy_ms / wall_ms:.1f}% of the wall, idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(n for n, _ in rows.values()) / T:.1f} device events/frame, "
            f"HtoD copies {rows.get('Memcpy HtoD', (0, 0))[0] / dispatches:.1f}"
            f"/dispatch ({dispatches} dispatches); by kind: {table} ({smi})")


def phase_profile(frames, smi: str) -> None:
    """The live path under torch.profiler, per frame and in chunks, on RGB
    frames or a YUV dict: device events per frame by kind, host-to-device
    copies per dispatch, and the device's busy share of the run's wall
    clock."""
    from vaudio_torch.api import Auralizer
    cfg = live_config()
    T = 16
    what = "YUV 4:2:0 " if isinstance(frames, dict) else ""
    source = as_source(clip_slice(frames, 0, T))
    for chunk in (1, LIVE_CHUNK):
        aur = Auralizer(source=source, config=cfg, device="cuda",
                        chunk_frames=chunk)
        aur.run_until_exhausted(timeout=300)        # warm-up
        aur = Auralizer(source=source, config=cfg, device="cuda",
                        chunk_frames=chunk)
        rows, wall_ms = profiled(lambda: aur.run_until_exhausted(
            timeout=300))
        say(profile_line(f"live {what}chunk_frames={chunk}", rows, wall_ms,
                         T, aur.metrics["dispatches"], smi))


def phase_realtime(frames: np.ndarray, smi: str) -> None:
    """REALTIME_T frames paced at 30 fps through a live stream per frame:
    latency p50 / p99 and achieved fps; a dropped frame fails the run."""
    from vaudio_torch.api import Auralizer
    cfg = live_config()
    aur = Auralizer(source=frames[:REALTIME_T], config=cfg, device="cuda",
                    realtime=True)
    pulled = []
    aur.start()
    consumer = threading.Thread(target=lambda: pulled.extend(
        b.size for b in aur.audio_stream(quantum=512, pace=True)))
    consumer.start()
    deadline = time.monotonic() + 120
    while aur.is_running and time.monotonic() < deadline:
        time.sleep(0.01)
    if aur.is_running:
        aur.stop()
        fail("real-time run did not finish within 120 s")
    aur.raise_if_failed()
    m = aur.metrics
    consumer.join(timeout=30)
    if m["frames_processed"] != REALTIME_T or m["dropped_frames"]:
        fail(f"real-time run: {m}")
    say(f"realtime: {REALTIME_T} frames {res_of(frames)} stereo 48 kHz paced "
        f"at {cfg.video_fps:g} fps, per frame: latency p50 "
        f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms "
        f"(+{m['hardware_latency_ms']:.3f} ms sink), achieved "
        f"{m['achieved_fps']:.2f} fps, dropped {m['dropped_frames']}, "
        f"underrun {m['underrun_samples']} samples, pulled {sum(pulled)} "
        f"samples ({smi})")


def phase_native(smi: str) -> None:
    """Build the C++ host runtime (``vaudio_torch/native``: the audio ring
    and the read-ahead frame reader) with g++ and print its time; fail
    unless it loads and the stream's ring is the C++ one."""
    from vaudio_torch.runtime import ringbuffer
    built = not ringbuffer.library_path().exists()
    t0 = time.perf_counter()
    path = ringbuffer.build()
    secs = time.perf_counter() - t0
    if ringbuffer._load_native() is None:
        fail(f"the native runtime {path} does not load")
    if not isinstance(ringbuffer.make_ring_buffer(4, 2, 1),
                      ringbuffer.NativeRingBuffer):
        fail("make_ring_buffer did not give the C++ ring")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    say(f"native: C++ ring and frame reader {'built' if built else 'found'}"
        f" in {secs:.2f} s ({gxx}, {' '.join(ringbuffer.CXX_FLAGS)}) -> "
        f"{path} ({smi})")


def http_json(url: str, body=None, timeout: float = HTTP_TIMEOUT_S):
    """GET (``body`` None) or POST ``body`` (bytes, or an object sent as
    JSON) to ``url``: (status, the JSON or raw reply)."""
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    with stacks_on_stall(url):
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                status, data, ctype = r.status, r.read(), r.headers.get(
                    "Content-Type", "")
        except urllib.error.HTTPError as e:
            status, data, ctype = e.code, e.read(), "application/json"
    return status, (json.loads(data) if "json" in ctype else data)


@contextlib.contextmanager
def stacks_on_stall(what: str):
    """Print every thread's stack to stderr when a request to the served
    stream takes more than ``STALL_S`` (faulthandler's own thread prints
    it, with no need of the GIL) and again when it fails other than by an
    HTTP status (a timeout, a reset), so that a stall names the thread it
    waited on.  Re-arms the whole run's watchdog after."""
    faulthandler.dump_traceback_later(STALL_S, file=sys.stderr)
    try:
        yield
    except (urllib.error.URLError, OSError):
        print(f"chip_smoke: {what}: no answer; every thread's stack:",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise
    finally:
        arm_watchdog()


def arm_watchdog() -> None:
    """Until ``RUN_LIMIT_S`` after the start of main(): at the limit,
    print every thread's stack and exit non-zero (a hang ends the run with
    its cause, inside the caller's time limit)."""
    if _deadline is None:
        faulthandler.cancel_dump_traceback_later()
    else:
        faulthandler.dump_traceback_later(
            max(1.0, _deadline - time.monotonic()), exit=True,
            file=sys.stderr)


def post_i420(url: str, clip, t: int) -> None:
    """Frame ``t`` of a YUV clip as a raw I420 body to ``POST /frames``."""
    from torch_frames import yuv420_bytes
    h, w = clip["y"].shape[1:]
    status, reply = http_json(f"{url}frames?w={w}&h={h}&fmt=i420",
                              yuv420_bytes(clip, t))
    if status != 200:
        fail(f"POST /frames (raw I420) answered {status}: {reply}")


def push_clip(url: str, clip) -> None:
    """Every frame of ``clip`` over HTTP, then close the push stream: RGB
    as ``.npy`` bodies through ``push_frames``, YUV as raw I420 bodies."""
    from vaudio_torch.io.push import push_frames
    if isinstance(clip, dict):
        for t in range(len(clip["y"])):
            post_i420(url, clip, t)
        http_json(url + "push", {"close": True})
    else:
        with stacks_on_stall(url + "frames"):
            push_frames(url, None, clip, timeout=HTTP_TIMEOUT_S)


def wait_stream_end(aur, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while aur.is_running and time.monotonic() < deadline:
        time.sleep(0.005)
    if aur.is_running:
        fail(f"{what}: the stream did not end within {timeout:g} s")
    aur.raise_if_failed()


def offline_by_pattern(clip, pattern, cfg):
    """The offline run on the card that a stream's dispatches make: a chunk
    through run_offline_batched, each run of single steps through
    run_offline, the carry chained; PCM as interleaved numpy."""
    from vaudio_torch.runtime import chunked, step
    outs, carry, start, k = [], None, 0, 0
    while k < len(pattern):
        n, singles = pattern[k], 0
        while k + singles < len(pattern) and pattern[k + singles] == 1:
            singles += 1
        part = clip_slice(clip, start, start + (singles or n))
        if singles:
            pcm, carry, _ = step.run_offline(part, cfg, carry=carry,
                                             device="cuda")
            k, start = k + singles, start + singles
        else:
            pcm, carry, _ = chunked.run_offline_batched(
                part, cfg, chunk=n, carry=carry, device="cuda")
            k, start = k + 1, start + n
        outs.append(pcm.cpu().numpy().reshape(-1))
    return np.concatenate(outs)


def check_endpoints(url: str, aur) -> str:
    """The operator endpoints of a served stream that has run: /metrics,
    /metrics.prom, the four PNG views, POST /params, a /state.npz round
    trip, and a malformed frame answered with 400."""
    status, m = http_json(url + "metrics")
    if status != 200 or m["frames_processed"] != LIVE_T:
        fail(f"GET /metrics: {status} {m}")
    status, prom = http_json(url + "metrics.prom")
    if status != 200 or f"vaudio_frames_processed {LIVE_T}" not in \
            prom.decode():
        fail(f"GET /metrics.prom: {status}")
    sizes = []
    for view in ("input", "hue_matrix", "spectrum", "waveform"):
        status, png = http_json(f"{url}debug/{view}.png")
        if status != 200 or not png.startswith(b"\x89PNG"):
            fail(f"GET /debug/{view}.png: {status}")
        sizes.append(f"{view} {len(png)} B")
    status, reply = http_json(url + "params", {"release": 2.5})
    if status != 200 or reply["applied"] != 1 or aur.params.release != 2.5:
        fail(f"POST /params: {status} {reply}")
    status, saved = http_json(url + "state.npz")
    before = aur._stream.snapshot_carry()
    status2, reply = http_json(url + "state.npz", saved)
    after = aur._stream.snapshot_carry()
    if status != 200 or status2 != 200 or not all(
            np.array_equal(a, b) for a, b in zip(before, after)):
        fail(f"/state.npz round trip: {status} {status2} {reply}")
    status, reply = http_json(url + "frames",
                              _npy(np.zeros((8, 8, 3), np.uint8)))
    if status != 400:
        fail(f"a malformed frame was answered {status}: {reply}")
    return (f"/metrics, /metrics.prom, PNG views ({', '.join(sizes)}), "
            f"POST /params, /state.npz round trip ({len(saved)} B) answered; "
            f"a malformed frame: 400 ({reply['error'][:48]}...)")


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def phase_serve(frames: np.ndarray, yuv: dict, live_ms: dict,
                smi: str) -> dict:
    """The serving path at ``live_config()``: 64 frames over HTTP into a
    served PushSource stream, RGB ``.npy`` and raw I420 bodies, per frame
    and in chunks of 8; launch counts, PCM against the offline runs on the
    card, the operator endpoints, ms/frame beside the in-process live
    run's; then a served stream per frame under torch.profiler.  Returns
    the counts by path."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import PushSource
    from vaudio_torch.runtime.ringbuffer import NativeRingBuffer
    cfg = live_config()
    counts = {}
    for clip in (frames[:LIVE_T], clip_slice(yuv, 0, LIVE_T)):
        is_yuv = isinstance(clip, dict)
        what = "raw I420" if is_yuv else ".npy RGB"
        pool = pool_of(clip)
        for chunk in (1, LIVE_CHUNK):
            path = ("serve" + ("_yuv" if is_yuv else "")
                    + ("_chunk" if chunk > 1 else ""))
            live = live_ms[("live_yuv" if is_yuv else "live")
                           + ("_chunk" if chunk > 1 else "_frame")]
            with tempfile.TemporaryDirectory() as tmp:
                log = os.path.join(tmp, "dispatches.jsonl")
                ps = PushSource(maxsize=LIVE_T, when_empty="block")
                aur = Auralizer(source=ps, config=cfg, device="cuda",
                                chunk_frames=chunk, metrics_log=log)
                srv = aur.serve(port=0)
                try:
                    reset_counts()
                    t0 = time.perf_counter()
                    aur.start()
                    # In chunks the first dispatch waits on the carry lock
                    # (as behind a concurrent /state.npz snapshot) until
                    # every frame is queued, so that whole chunks form.
                    hold = (aur._stream._carry_lock if chunk > 1
                            else contextlib.nullcontext())
                    with hold:
                        push_clip(srv.url, clip)
                        t_pushed = time.perf_counter()
                    wait_stream_end(aur, 300, f"serve {path}")
                    wall = time.perf_counter() - t0
                    launches = read_counts()
                    m = aur.metrics
                    ring = type(aur._stream.ring).__name__
                    got = aur.pull(LIVE_T * cfg.hop_size * cfg.channels)
                    extra = (check_endpoints(srv.url, aur)
                             if path == "serve" else "")
                finally:
                    srv.stop()
                    aur.stop()
                pattern = [json.loads(line)["frames"] for line in open(log)]
            counts[path] = launches
            if ring != NativeRingBuffer.__name__:
                fail(f"serve {path}: the stream's ring is a {ring}")
            if (m["frames_processed"] != LIVE_T or m["dropped_frames"]
                    or ps.dropped or ps.pushed != LIVE_T):
                fail(f"serve {path}: {m}, queue {ps.state()}")
            need = [pool, "hann_peak_weighted_sum", "vision_stats",
                    "agc_overlap_add"]
            if min(launches[k] for k in need) < 1:
                fail(f"serve {path}: a kernel of the path never launched: "
                     f"{launches}")
            if launches["agc_overlap_add"] != len(pattern) or (
                    chunk == 1 and len(pattern) != LIVE_T):
                fail(f"serve {path}: K4 launched "
                     f"{launches['agc_overlap_add']} times in "
                     f"{len(pattern)} dispatches")
            if is_yuv and (launches[pool] != len(pattern)
                           or launches["mip_pool_u8"]
                           or launches["mip_pool_planes_u8"]):
                fail(f"serve {path}: not exactly 1 K1 launch a dispatch "
                     f"(the YUV entry's), or another K1 entry launched: "
                     f"{launches}, {len(pattern)} dispatches")
            if chunk > 1 and LIVE_CHUNK not in pattern:
                fail(f"serve {path}: no chunk of {LIVE_CHUNK} formed: "
                     f"{pattern}")
            ref = offline_by_pattern(clip, pattern, cfg)
            if not np.array_equal(got, ref):
                fail(f"serve {path}: the pulled PCM differs from the offline "
                     f"run on the card by {np.abs(got - ref).max():.3e}")
            if not np.any(got != 0):
                fail(f"serve {path}: silent")
            shape = (f"{pattern.count(LIVE_CHUNK)} chunks of {LIVE_CHUNK} "
                     f"and {pattern.count(1)} single steps" if chunk > 1
                     else f"{len(pattern)} single steps")
            per = 1e3 / LIVE_T
            took = f"{per * wall:.3f} ms/frame from the first push to the "
            took += ("stream's end" if chunk == 1 else
                     f"stream's end (the push {per * (t_pushed - t0):.3f}, "
                     f"then the queued chunks "
                     f"{per * (wall - (t_pushed - t0)):.3f})")
            say(f"serve: {LIVE_T} {what} frames 1080x1920 stereo 48 kHz "
                f"through POST /frames, chunk_frames={chunk} ({shape}): "
                f"{took}, in-process live {live:.3f} ms/frame; latency "
                f"p50 {m['latency_p50_ms']:.3f} ms p99 "
                f"{m['latency_p99_ms']:.3f} ms; nothing dropped, ring "
                f"{ring}; PCM equal to the offline run on the card with the "
                f"stream's dispatches; launches {launches} ({smi})")
            if extra:
                say(f"serve: {extra} ({smi})")
    for clip in (frames[:16], clip_slice(yuv, 0, 16)):
        what = "YUV 4:2:0 raw I420" if isinstance(clip, dict) else ".npy RGB"
        ps = PushSource(maxsize=16, when_empty="block")
        aur = Auralizer(source=ps, config=cfg, device="cuda")
        srv = aur.serve(port=0)

        def run():
            aur.start()
            push_clip(srv.url, clip)
            wait_stream_end(aur, 300, "serve profile")

        try:
            rows, wall_ms = profiled(run)
        finally:
            srv.stop()
            aur.stop()
        say(profile_line(f"served {what} chunk_frames=1", rows, wall_ms, 16,
                         aur.metrics["dispatches"], smi))
    return counts


def phase_native_reader(frames: np.ndarray, yuv: dict, smi: str) -> None:
    """64 frames of 1080p rgb24 and I420 written to a file and streamed
    through RawVideoSource(native=True, zero_copy=True): the frames are
    the C++ reader's borrowed pool views, and the PCM equals the in-memory
    source's run on the card."""
    from torch_frames import yuv420_bytes

    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import BorrowedFrame, RawVideoSource
    cfg = live_config()
    with tempfile.TemporaryDirectory() as tmp:
        for clip in (frames[:LIVE_T], clip_slice(yuv, 0, LIVE_T)):
            is_yuv = isinstance(clip, dict)
            H, W = (clip["y"] if is_yuv else clip).shape[1:3]
            path = os.path.join(tmp, "clip.i420" if is_yuv else "clip.rgb")
            with open(path, "wb") as f:
                for t in range(LIVE_T):
                    f.write(yuv420_bytes(clip, t) if is_yuv
                            else clip[t].tobytes())
            src = RawVideoSource(path, W, H,
                                 pix_fmt="i420" if is_yuv else "rgb24",
                                 raw=is_yuv, native=True, zero_copy=True)
            it = src.frames()
            first = next(it)
            it.close()
            if not isinstance(first["y"] if is_yuv else first,
                              BorrowedFrame):
                fail("RawVideoSource(native=True, zero_copy=True) did not "
                     "yield the native reader's pool views")
            pcm, ms = [], []
            for source in (src, as_source(clip)):
                aur = Auralizer(source=source, config=cfg, device="cuda")
                t0 = time.perf_counter()
                aur.run_until_exhausted(timeout=300)
                ms.append(1e3 * (time.perf_counter() - t0) / LIVE_T)
                if aur.metrics["frames_processed"] != LIVE_T:
                    fail(f"native reader: {aur.metrics}")
                pcm.append(aur.pull(LIVE_T * cfg.hop_size * cfg.channels))
            if not np.array_equal(pcm[0], pcm[1]) or not np.any(pcm[0]):
                fail("native reader: the PCM differs from the in-memory "
                     "source's run (or is silent)")
            say(f"native reader: {LIVE_T} frames 1080x1920 "
                f"{'I420' if is_yuv else 'rgb24'} "
                f"({os.path.getsize(path) / 1e6:.0f} MB file) through "
                f"RawVideoSource(native=True, zero_copy=True), per frame: "
                f"{ms[0]:.3f} ms/frame, the in-memory source {ms[1]:.3f}; "
                f"PCM equal bit for bit ({smi})")


def phase_paced(frames: np.ndarray, smi: str) -> None:
    """90 frames pushed at 30 fps into the default maxsize=8 queue of a
    served stream, GET /audio.wav the only consumer of its ring: latency
    p50 / p99, fps, dropped frames, the WAV's RIFF header and
    non-silence."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import PushSource
    from vaudio_torch.io.push import push_frames
    cfg = live_config()
    ps = PushSource(when_empty="block")
    aur = Auralizer(source=ps, config=cfg, device="cuda")
    srv = aur.serve(port=0)
    wav: dict = {}

    def listen():
        with urllib.request.urlopen(srv.url + "audio.wav",
                                    timeout=120) as r:
            wav["body"] = r.read()       # until the stream ends and drains

    listener = threading.Thread(target=listen, daemon=True)
    try:
        aur.start()
        listener.start()
        t0 = time.perf_counter()
        with stacks_on_stall(srv.url + "frames"):
            sent = push_frames(srv.url, None, frames[:REALTIME_T],
                               fps=cfg.video_fps, timeout=HTTP_TIMEOUT_S)
        push_s = time.perf_counter() - t0
        wait_stream_end(aur, 120, "paced serve")
        m = aur.metrics
        listener.join(timeout=120)
    finally:
        srv.stop()
        aur.stop()
    if listener.is_alive() or "body" not in wav:
        fail("paced serve: /audio.wav did not end with the stream")
    body = wav["body"]
    pcm = np.frombuffer(body[44:len(body) - len(body) % 2], "<i2")
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE" or body[36:40] != \
            b"data" or not pcm.size or np.abs(pcm).max() <= 50:
        peak = np.abs(pcm).max() if pcm.size else 0
        fail(f"paced serve: /audio.wav header {body[:44]!r}, "
             f"{pcm.size} samples, peak {peak}")
    if sent != REALTIME_T or m["frames_processed"] != REALTIME_T - ps.dropped:
        fail(f"paced serve: sent {sent}, {m}, queue {ps.state()}")
    say(f"paced: {REALTIME_T} .npy RGB frames 1080x1920 stereo 48 kHz pushed "
        f"at {cfg.video_fps:g} fps ({sent / push_s:.2f} fps sent) into "
        f"PushSource(maxsize={ps.maxsize}): latency p50 "
        f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms, "
        f"achieved {m['achieved_fps']:.2f} fps, dropped {ps.dropped} at the "
        f"queue and {m['dropped_frames']} at the ring; /audio.wav the only "
        f"consumer: RIFF/WAVE header, {pcm.size} int16 samples "
        f"({pcm.size / cfg.channels / cfg.sample_rate:.2f} s), peak "
        f"{np.abs(pcm).max()} ({smi})")


# ---------------------------------------------------------------------------
# The OrthoModes family
# ---------------------------------------------------------------------------

# Operations per (frame, bin, oscillator) of the plain Hann x Lorentzian
# synthesis (models.orthomodes.peak_spectra): the distance (2), the Hann
# lobe (hann_sinc_peak_fast, 25) and its scale (1), the Lorentzian (lambda
# d, its square, 1 +, the divide: 4), their product (1) and the contraction
# with the two weight columns (4).
ORTHO_PEAK_OPS = 37


def ortho_config():
    """The OrthoModes phases' AuralizerConfig: stereo 48 kHz as asked, which
    the engine coerces to mono and unfiltered."""
    from vaudio_torch.config import AuralizerConfig
    return AuralizerConfig(sample_rate=48000.0, channels=2,
                           ring_buffer_frames=LIVE_T + 8)


def ortho_by_pattern(clip, pattern, cfg, params=None):
    """The OrthoModes model's steps on the card with a stream's dispatches:
    a chunk of n > 1 frames through ``chunk_step``, a single frame through
    ``frame_step``, the carry chained; mono PCM as numpy."""
    from vaudio_torch.config import LiveParams
    from vaudio_torch.runtime.engine import OrthoModesEngine
    engine = OrthoModesEngine(cfg, device="cuda")
    model = engine.model
    params = params or engine.params_arrays(LiveParams())
    carry = model.init_carry(model.num_oscillators(*clip.shape[1:3]))
    outs, start = [], 0
    for n in pattern:
        if n == 1:
            carry, pcm = model.frame_step(carry, clip[start], params)
        else:
            carry, pcm, _ = model.chunk_step(carry, clip[start:start + n],
                                             params)
        outs.append(pcm.reshape(-1))
        start += n
    return torch.cat(outs).cpu().numpy()


def ortho_checks(what: str, launches: dict, dispatches: int) -> None:
    """Fail unless K1's interleaved entry and K4 launched once a dispatch
    and no other kernel launched."""
    want = {k: 0 for k in launches}
    want.update(mip_pool_u8=dispatches, agc_overlap_add=dispatches)
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want} ({dispatches} "
             f"dispatches)")


def phase_ortho_offline(frames: np.ndarray, smi: str) -> float:
    """``Auralizer(model="orthomodes").sonify`` on 64 1080p frames, from
    host and from device frames: launch counts (K1 and K4 once for the
    block of 64), the PCM finite and audible, a profile of the run; the
    256x256 crop on the card against the port on the CPU (PCM within
    1e-4); the plain synthesis's device time per frame beside its bound.
    Returns the launch counts of the host-frame run."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.models import orthomodes
    cfg = ortho_config()
    T, H, W = frames.shape[:3]
    aur = Auralizer(config=cfg, model="orthomodes", device="cuda")
    if aur.config.channels != 1:
        fail("orthomodes: the config was not coerced to mono")
    aur.sonify(frames)                              # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    audio = aur.sonify(frames)
    wall = time.perf_counter() - t0
    launches = read_counts()
    ortho_checks("orthomodes offline", launches, -(-T // CHUNK_T))
    if audio.shape != (T * cfg.hop_size,) or not np.all(np.isfinite(audio)) \
            or not np.abs(audio).max() > 1e-3:
        fail(f"orthomodes offline: PCM of shape {audio.shape} not finite or "
             f"silent")
    dev_clip = torch.as_tensor(frames, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = aur.sonify(dev_clip)
    wall_dev = time.perf_counter() - t1
    if not np.array_equal(again, audio):
        fail("orthomodes offline: device frames give other PCM than host "
             "frames")
    rows, wall_ms = profiled(lambda: aur.sonify(dev_clip))
    say(f"orthomodes offline: Auralizer(model='orthomodes').sonify {T} "
        f"frames {H}x{W} at mip {ORTHO_MIP} ({(H >> ORTHO_MIP) * (W >> ORTHO_MIP)}"
        f" oscillators), 48 kHz mono: {1e3 * wall / T:.3f} ms/frame from "
        f"host frames, {1e3 * wall_dev / T:.3f} ms/frame from device frames "
        f"({smi}); launches {launches}")
    say(profile_line("orthomodes offline from device frames", rows, wall_ms,
                     T, 1, smi, f"{H}x{W} mono"))
    crop = crop256(frames)
    pcm = {d: Auralizer(config=cfg, model="orthomodes", device=d).sonify(
        crop) for d in ("cuda", "cpu")}
    err = float(np.abs(pcm["cuda"] - pcm["cpu"]).max())
    if not err <= 1e-4 or not np.abs(pcm["cpu"]).max() > 1e-3:
        fail(f"orthomodes offline 256x256 crop: PCM card vs CPU differs by "
             f"{err:.3e} (or is silent)")
    say(f"orthomodes offline: {T}-frame 256x256 crop card vs CPU: PCM max "
        f"diff {err:.3e} (band 1e-4) ({smi})")

    model = aur._engine.model
    params = orthomodes.params_on(model.default_params(), "cuda")
    amp, q, f0 = orthomodes.extract_pixel_modes(dev_clip[:16], params,
                                                model.cfg)
    P, F = f0.shape[1], model.cfg.num_bins
    consts = model._consts(P)
    phases = torch.remainder(f0 * 0.29, 6.28)       # any phases will do
    for n in (1, 16):
        def synth():
            return orthomodes.peak_spectra(amp[:n], q[:n], f0[:n],
                                           phases[:n], model.cfg, consts)
        dev_ms = device_ms(synth)
        ev_ms = cuda_ms(synth)
        b_ms, b_by = bound(4 * (4 * n * P + 3 * F + P + 2 * n * F),
                           n * F * P * ORTHO_PEAK_OPS)
        say(f"orthomodes synthesis (plain PyTorch, models.orthomodes."
            f"peak_spectra) T={n} F={F} P={P}: {dev_ms / n:.4f} ms/frame on "
            f"the device ({ev_ms / n:.4f} from events), bound "
            f"{b_ms / n:.6f} ms/frame ({b_by}, {ORTHO_PEAK_OPS} operations "
            f"a peak), share of the bound {100 * b_ms / dev_ms:.2f}% "
            f"({smi})")
    return launches


def phase_ortho_live(frames: np.ndarray, smi: str) -> dict:
    """The OrthoModes live stream on 64 1080p frames, per frame and in
    chunks of 8: launch counts (K1 and K4 once a dispatch), the PCM equal
    bit for bit to the model's steps on the card with the stream's
    dispatches; then 16 frames of each under torch.profiler.  Returns the
    counts by path."""
    from vaudio_torch.api import Auralizer
    cfg = ortho_config()
    clip = frames[:LIVE_T]
    H, W = clip.shape[1:3]
    counts = {}
    for chunk, path in ((1, "ortho_live_frame"),
                        (LIVE_CHUNK, "ortho_live_chunk")):
        Auralizer(source=clip[:LIVE_CHUNK], config=cfg, model="orthomodes",
                  device="cuda", chunk_frames=chunk).run_until_exhausted(
                      timeout=300)                  # warm-up
        aur = Auralizer(source=clip, config=cfg, model="orthomodes",
                        device="cuda", chunk_frames=chunk)
        reset_counts()
        t0 = time.perf_counter()
        aur.run_until_exhausted(timeout=300)
        wall = time.perf_counter() - t0
        counts[path] = launches = read_counts()
        m = aur.metrics
        if m["frames_processed"] != LIVE_T or m["dropped_frames"]:
            fail(f"orthomodes live chunk_frames={chunk}: {m}")
        ortho_checks(f"orthomodes live chunk_frames={chunk}", launches,
                     m["dispatches"])
        got = aur.pull(LIVE_T * cfg.hop_size)
        pattern = [chunk] * (LIVE_T // chunk)
        ref = ortho_by_pattern(clip, pattern, aur.config)
        if not np.array_equal(got, ref) or not np.abs(got).max() > 1e-3:
            fail(f"orthomodes live chunk_frames={chunk}: the pulled PCM "
                 f"differs from the model's steps on the card by "
                 f"{np.abs(got - ref).max():.3e} (or is silent)")
        say(f"orthomodes live: Auralizer(model='orthomodes')"
            f".run_until_exhausted {LIVE_T} frames {H}x{W} 48 kHz mono "
            f"chunk_frames={chunk}: {1e3 * wall / LIVE_T:.3f} ms/frame, "
            f"latency p50 {m['latency_p50_ms']:.3f} ms p99 "
            f"{m['latency_p99_ms']:.3f} ms; PCM equal to the model's steps "
            f"on the card with the stream's dispatches; launches {launches}"
            f" in {m['dispatches']} dispatches ({smi})")
    for chunk in (1, LIVE_CHUNK):
        aur = Auralizer(source=clip[:16], config=cfg, model="orthomodes",
                        device="cuda", chunk_frames=chunk)
        rows, wall_ms = profiled(lambda: aur.run_until_exhausted(
            timeout=300))
        say(profile_line(f"orthomodes live chunk_frames={chunk}", rows,
                         wall_ms, 16, aur.metrics["dispatches"], smi,
                         f"{H}x{W} mono"))
    return counts


def serve_ortho(clip, cfg, state=None, log=None, before_push=None):
    """A served OrthoModes stream fed ``clip`` over ``POST /frames`` (.npy
    bodies, the push stream closed at the end), after restoring ``state``
    (a /state.npz body) when given: (pcm, the /state.npz body at the end,
    metrics, launches, whatever ``before_push(url)`` returned)."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import PushSource
    ps = PushSource(maxsize=LIVE_T, when_empty="block")
    aur = Auralizer(source=ps, config=cfg, model="orthomodes",
                    device="cuda", metrics_log=log, debug=True)
    srv = aur.serve(port=0)
    try:
        if state is not None:
            status, reply = http_json(srv.url + "state.npz", state)
            if status != 200:
                fail(f"orthomodes serve: POST /state.npz {status} {reply}")
        reset_counts()
        aur.start()
        early = before_push(srv.url) if before_push else None
        push_clip(srv.url, clip)
        wait_stream_end(aur, 300, "orthomodes serve")
        launches = read_counts()
        status, saved = http_json(srv.url + "state.npz")
        if status != 200:
            fail(f"orthomodes serve: GET /state.npz {status}")
        m = aur.metrics
        if m["frames_processed"] != len(clip) or ps.dropped or \
                m["dropped_frames"]:
            fail(f"orthomodes serve: {m}, queue {ps.state()}")
        pcm = aur.pull(len(clip) * cfg.hop_size)
    finally:
        srv.stop()
        aur.stop()
    return pcm, saved, m, launches, early


def phase_ortho_serve(frames: np.ndarray, smi: str) -> dict:
    """64 .npy RGB frames through ``LiveServer`` ``POST /frames`` into a
    served OrthoModes stream: /state.npz answered 409 before the first
    frame, an I420 body 400, the spectrum and waveform views rendered (no
    hue view: 404), K1 and K4 once a dispatch, the PCM equal to the model's
    steps on the card; then /state.npz taken after 32 frames and restored
    into a fresh served stream: the continued PCM equals the uninterrupted
    run bit for bit.  Returns the counts of the whole run."""
    cfg = ortho_config()
    clip = frames[:LIVE_T]
    H, W = clip.shape[1:3]

    def door_checks(url):
        status, reply = http_json(url + "state.npz")
        if status != 409 or "carry" not in reply.get("error", ""):
            fail(f"orthomodes serve: /state.npz before the first frame "
                 f"answered {status} {reply}")
        status, reply = http_json(f"{url}frames?w={W}&h={H}&fmt=i420",
                                  bytes(H * W * 3 // 2))
        if status != 400 or "RGB-only" not in reply.get("error", ""):
            fail(f"orthomodes serve: an I420 body answered {status} {reply}")
        return reply["error"]

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "dispatches.jsonl")
        t0 = time.perf_counter()
        pcm, _, m, launches, i420 = serve_ortho(clip, cfg, log=log,
                                                before_push=door_checks)
        wall = time.perf_counter() - t0
        pattern = [json.loads(line)["frames"] for line in open(log)]
    ortho_checks("orthomodes serve", launches, len(pattern))
    ref = ortho_by_pattern(clip, pattern, cfg)
    if not np.array_equal(pcm, ref) or not np.abs(pcm).max() > 1e-3:
        fail(f"orthomodes serve: the pulled PCM differs from the model's "
             f"steps on the card by {np.abs(pcm - ref).max():.3e}")
    half = LIVE_T // 2
    first, saved, _, _, _ = serve_ortho(clip[:half], cfg)
    second, _, _, _, _ = serve_ortho(clip[half:], cfg, state=saved)
    if not np.array_equal(np.concatenate([first, second]), pcm):
        fail("orthomodes serve: the PCM continued from /state.npz differs "
             "from the uninterrupted run")
    say(f"orthomodes serve: {LIVE_T} .npy RGB frames {H}x{W} through "
        f"POST /frames ({len(pattern)} dispatches): {1e3 * wall / LIVE_T:.3f}"
        f" ms/frame from the first push to the stream's end; latency p50 "
        f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms; "
        f"PCM equal to the model's steps on the card; /state.npz 409 before "
        f"the first frame; I420 400 ({i420[:40]}...); /state.npz "
        f"({len(saved)} B) after {half} frames restored into a fresh served "
        f"stream: PCM equal to the uninterrupted run; launches {launches} "
        f"({smi})")
    return {"ortho_serve": launches}


def phase_ortho_resolution(frames: np.ndarray, smi: str) -> None:
    """A resolution change mid-stream (8 frames of 1080p, then 8 of 720p)
    re-inits the frame-sized carry: counted, and the 720p part's PCM equal
    to a cold run on it; a 720p checkpoint restored into a 1080p stream
    fails with carry_mismatch's message."""
    from vaudio_torch.api import Auralizer
    cfg = ortho_config()
    big = frames[:8]
    small = np.ascontiguousarray(frames[8:16, :720, :1280])
    aur = Auralizer(source=list(big) + list(small), config=cfg,
                    model="orthomodes", device="cuda")
    aur.run_until_exhausted(timeout=300)
    m = aur.metrics
    if m["resolution_changes"] != 1 or m["frames_processed"] != 16:
        fail(f"orthomodes resolution change: {m}")
    pcm = aur.pull(16 * cfg.hop_size)
    ref = ortho_by_pattern(small, [1] * 8, aur.config)
    if not np.array_equal(pcm[8 * cfg.hop_size:], ref):
        fail("orthomodes resolution change: the 720p part differs from a "
             "cold run on it")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "720p.npz")
        aur.save_state(path)
        aur.stop()
        wrong = Auralizer(source=big[:2], config=cfg, model="orthomodes",
                          device="cuda")
        wrong.load_state(path)
        try:
            wrong.run_until_exhausted(timeout=300)
        except RuntimeError as e:
            msg = str(e.__cause__)
        else:
            fail("orthomodes: a 720p checkpoint ran on 1080p frames")
        if "oscillators" not in msg:
            fail(f"orthomodes: wrong-resolution restore failed with {msg}")
    say(f"orthomodes resolution change: 8 frames 1080x1920 then 8 at "
        f"720x1280: resolution_changes {m['resolution_changes']}, the 720p "
        f"part equal to a cold run; a 720p checkpoint on 1080p frames: "
        f"{msg} ({smi})")


POD_S = 4                        # slots of the flagship pod phases
POD_T = 16                       # frames a slot
POD_BAND = 2e-6                  # pod vs single-stream PCM where not exact


def phase_k4_streams(smi: str) -> list:
    """K4 on a stream axis at the pod's shapes: S = 8, T = 8 stereo in the
    chunk order, S = 8 in the frame order (one frame, the per-frame pod
    with use_pallas), S = 2, T = 8 mono in the frame order at T frames (the
    OrthoModes pod): within 1e-6 of the plain version (S plain calls), each
    stream equal bit for bit to a launch on that stream alone, one device
    kernel per call; the entries' times."""
    from torch.profiler import ProfilerActivity, profile
    from torch_frames import k4_stream_args, k4_stream_forms
    rng = np.random.default_rng(1)
    entries = []
    for S, T, C, order, path in ((8, LIVE_CHUNK, 2, "chunk", "pod_chunk"),
                                 (8, 1, 2, "frame", "pod_frame"),
                                 (2, LIVE_CHUNK, 1, "frames",
                                  "ortho_pod_chunk")):
        fn, plain, frames_of = k4_stream_forms(order)
        sig, tail, window, *scal = k4_stream_args(rng, S, T, C,
                                                  device="cuda")
        args = [frames_of(sig), tail, window, *scal]
        name = f"K4 {order} order, stream axis S={S} T={T} C={C}"
        got = fn(*args)
        err = k4_err(name, got, plain(*args))
        for k in range(S):
            one = fn(args[0][k].contiguous(), tail[k], window,
                     *(x[k] for x in scal))
            if not all(bits_equal(g[k], r) for g, r in zip(got, one)):
                fail(f"{name}: stream {k} differs from a launch on it alone")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not (1 <= len(kernels) <= 20
                and all("agc_overlap_add" in k for k in kernels)):
            fail(f"{name}: device kernels of 10 calls: {kernels}")
        nfft, hop = 4096, 2048
        e = entry(f"agc_overlap_add_streams_s{S}" + ("_frames" if order ==
                                                     "frames" else "")
                  + f"_t{T}", "vaudio_torch/csrc/audio_kernel.cu",
                  "vaudio/ops/audio_kernel.py:70", err,
                  functools.partial(fn, *args),
                  functools.partial(plain, *args),
                  nbytes=4 * S * (T * C * nfft + C * hop + 3 + T * C * hop
                                  + C * nfft + 1) + 4 * nfft,
                  ops=S * T * (6 * C * nfft + C * hop), path=path,
                  counter="agc_overlap_add")
        say(f"{name}: max_abs_err {err:.3e}; each stream equal to a launch "
            f"on it alone; {len(kernels) / 10:g} device kernels per call; "
            f"{timing(e)} ({smi})")
        entries.append(e)
    return entries


def run_pod(pod, sources, what: str) -> float:
    """Run ``pod`` over ``sources`` to their end; the wall clock in s."""
    t0 = time.perf_counter()
    pod.start(sources)
    while pod.is_running:
        if time.perf_counter() - t0 > 300:
            pod.stop()
            fail(f"{what}: the pod still runs after 300 s")
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    try:
        pod.raise_if_failed()
    except RuntimeError as e:
        fail(f"{what}: {e.__cause__!r}")
    return wall


def pod_profile_line(label: str, rows: dict, wall_ms: float, ticks: int,
                     smi: str) -> str:
    busy_ms = sum(us for _, us in rows.values()) / 1e3
    if busy_ms <= 0:
        return (f"pod profile: {label}: torch.profiler recorded no device "
                f"events: not measured")
    table = ", ".join(f"{k} {n / ticks:.2f}/tick {us / 1e3 / ticks:.4f} ms"
                      for k, (n, us) in sorted(rows.items(),
                                               key=lambda r: -r[1][1]))
    return (f"pod profile: {label}, {ticks} ticks: wall {wall_ms / ticks:.3f}"
            f" ms/tick, device busy {busy_ms / ticks:.4f} ms/tick "
            f"({100 * busy_ms / wall_ms:.1f}% of the wall, idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(n for n, _ in rows.values()) / ticks:.1f} device "
            f"events/tick; by kind: {table} ({smi})")


def pod_case(label, make_pod, sources, refs, exact, need, smi):
    """One pod run: warm-up, the counted run, the checks of each slot
    against ``refs`` (flat PCM of its real frames), a profiled run.
    ``need``: {kernel counter: launches a tick}.  Returns (counts, the
    pod of the counted run, the pulled PCM by slot)."""
    run_pod(make_pod(), [s[:LIVE_CHUNK] for s in sources], label)
    torch.cuda.synchronize()
    pod = make_pod()
    reset_counts()
    wall = run_pod(pod, sources, label)
    launches = read_counts()
    ticks = pod.metrics.dispatches
    want = {k: 0 for k in launches}
    want.update({k: n * ticks for k, n in need.items()})
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want} in {ticks} "
             f"ticks")
    ch = pod.cfg.channels * pod.cfg.hop_size
    pcm, errs = [], []
    for i, ref in enumerate(refs):
        if pod.stream_metrics(i)["buffer_fill"] != len(ref) // ch:
            fail(f"{label}: slot {i} holds "
                 f"{pod.stream_metrics(i)['buffer_fill']} hops, expected "
                 f"{len(ref) // ch}")
        got = pod.pull(i, len(ref))
        err = float(np.abs(got - ref).max())
        if (exact and not np.array_equal(got, ref)) or not err <= POD_BAND \
                or not np.abs(got).max() > 1e-3:
            fail(f"{label}: slot {i} differs from its single-stream run by "
                 f"{err:.3e} ({'bit for bit' if exact else POD_BAND} asked)"
                 f" or is silent")
        pcm.append(got)
        errs.append(err)
    frames = pod.metrics.frames_processed
    say(f"pod: {label}: {ticks} ticks, {frames} real frames, "
        f"{1e3 * wall / ticks:.3f} ms/tick, {frames / wall:.1f} frames/s "
        f"aggregate; launches {launches}; each slot's PCM "
        f"{'equal to its single-stream run bit for bit' if exact else f'within {POD_BAND} of its single-stream run'}"
        f" (max {max(errs):.3e}) ({smi})")
    prof_pod = make_pod()
    rows, wall_ms = profiled(lambda: run_pod(prof_pod, sources, label))
    say(pod_profile_line(label, rows, wall_ms, prof_pod.metrics.dispatches,
                         smi))
    return launches, pod, pcm


def phase_pod(frames: np.ndarray, yuv: dict, smi: str) -> dict:
    """The serving pod (runtime.multistream) at 1080p: the flagship's live
    configuration with S = 4 slots (slot 3 ends after 12 frames) per frame
    and in chunks of 8, the same on I420 dicts per frame, OrthoModes with S
    = 2 in chunks of 8; a checkpoint after 8 frames restored into a second
    pod.  Returns the counts by path."""
    from vaudio_torch.runtime import MultiStreamAuralizer, chunked, step
    from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine
    cfg = live_config()
    clips = [clip_slice(frames, POD_T * k, POD_T * (k + 1))
             for k in range(POD_S)]
    clips[-1] = clips[-1][:12]      # a dark slot for the last 4 ticks
    shape = "x".join(map(str, frames.shape[1:3]))
    counts = {}
    need = {"mip_pool_u8": 1, "hann_peak_weighted_sum": 1,
            "vision_stats": 1, "agc_overlap_add": 1}

    def flagship(chunk):
        return lambda: MultiStreamAuralizer(
            cfg, n_streams=POD_S, engine=AuralizerEngine(cfg),
            chunk_frames=chunk)

    finals = {}
    for chunk, path in ((1, "pod_frame"), (LIVE_CHUNK, "pod_chunk")):
        refs = []
        for clip in clips:
            if chunk == 1:
                ref, carry, _ = step.run_offline(clip, cfg, device="cuda")
            else:
                ref, carry, _ = chunked.run_offline_batched(
                    clip, cfg, chunk=chunk, device="cuda")
            refs.append(ref.cpu().numpy().reshape(-1))
            finals.setdefault(path, []).append(carry.hues.cpu().numpy())
        counts[path], pod, pcm = pod_case(
            f"flagship S={POD_S} {shape} stereo chunk_frames={chunk}",
            flagship(chunk), clips, refs, chunk == 1, need, smi)
        hues = pod.snapshot_carry().hues
        if not np.array_equal(hues[:-1], np.stack(finals[path][:-1])):
            fail(f"pod {path}: the slots' hues differ from their "
                 f"single-stream runs'")
        if chunk == 1:
            uninterrupted = pcm

    # A checkpoint after 8 frames, restored into a second pod.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pod.npz")
        first = flagship(1)()
        run_pod(first, [c[:8] for c in clips], "pod checkpoint, first half")
        half = [first.pull(i, 8 * cfg.hop_size * 2) for i in range(POD_S)]
        first.save_state(path)
        first.stop()
        second = flagship(1)()
        second.load_state(path)
        run_pod(second, [c[8:] for c in clips], "pod checkpoint, restored")
        for i, clip in enumerate(clips):
            rest = second.pull(i, (len(clip) - 8) * cfg.hop_size * 2)
            if not np.array_equal(np.concatenate([half[i], rest]),
                                  uninterrupted[i]):
                fail(f"pod checkpoint: slot {i} differs from the "
                     f"uninterrupted run")
        size = os.path.getsize(path)
    say(f"pod: save_state after 8 frames ({size} B) and load_state into a "
        f"second pod: every slot's PCM equal to the uninterrupted pod's bit "
        f"for bit ({smi})")

    ysrc = [as_source(clip_slice(yuv, POD_T * k, POD_T * (k + 1)))
            for k in range(POD_S)]
    yrefs = [step.run_offline(clip_slice(yuv, POD_T * k, POD_T * (k + 1)),
                              cfg, device="cuda")[0].cpu().numpy()
             .reshape(-1) for k in range(POD_S)]
    yneed = {"mip_pool_yuv420_u8": 1, "hann_peak_weighted_sum": 1,
             "vision_stats": 1, "agc_overlap_add": 1}
    counts["pod_yuv_frame"], _, _ = pod_case(
        f"flagship S={POD_S} YUV 4:2:0 {shape} stereo chunk_frames=1",
        flagship(1), ysrc, yrefs, True, yneed, smi)

    ocfg = ortho_config()
    oclips = clips[:2]
    orefs = [ortho_by_pattern(c, [LIVE_CHUNK] * (POD_T // LIVE_CHUNK), ocfg)
             for c in oclips]

    def ortho():
        eng = OrthoModesEngine(ocfg)
        return MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                    chunk_frames=LIVE_CHUNK)
    counts["ortho_pod_chunk"], _, _ = pod_case(
        f"OrthoModes S=2 {shape} mip {ORTHO_MIP} mono "
        f"chunk_frames={LIVE_CHUNK}", ortho, oclips, orefs, True,
        {"mip_pool_u8": 1, "agc_overlap_add": 1}, smi)
    return counts


def via(what: str, call):
    """``call()``, a request through vaudio_torch.client, under the stall
    watch; an error answer fails the run."""
    from vaudio_torch.client import VaudioHTTPError
    with stacks_on_stall(what):
        try:
            return call()
        except VaudioHTTPError as e:
            fail(f"{what}: {e}")


def serve_pod_case(label, make_pod, clips, ref, need, smi, state=None,
                   slot_views=("hue_matrix", "spectrum", "waveform",
                               "input"), record=False):
    """One served pod: ``make_pod()`` behind ``pod.serve(port=0)``, one
    slot a clip leased through ``PodClient.acquire`` and filled over HTTP
    (RGB as ``.npy`` bodies through ``PodSlot.push``, YUV as raw I420
    bodies) before ``pod.start``, so that every tick sees the same frames
    as the in-process pod's; ``state`` (a /state.npz body) is POSTed first
    and the slots leased warm.  Checks: launches ``need`` once a tick, with
    the counts set to 0 before the first request and read after the last;
    each slot's PCM (``pod.pull``; slot 0 through ``PodSlot.record`` when
    ``record``) equal bit for bit to ``ref`` (flat PCM by slot); /metrics'
    frame_sig; the slot views (a view not in ``slot_views`` answers 404).
    Returns (launches, the /state.npz body after the run, a time line)."""
    from vaudio_torch.client import PodClient, frame_sig_json
    pod = make_pod()
    srv = pod.serve(port=0)
    client = PodClient(srv.url, timeout=HTTP_TIMEOUT_S)
    try:
        reset_counts()
        if state is not None:
            via(f"{label}: POST /state.npz",
                lambda: client.load_state(state))
        slots = [via(f"{label}: acquire",
                     lambda: client.acquire(maxsize=POD_T, when_empty="dark",
                                            reset=state is None))
                 for _ in clips]
        if [s.index for s in slots] != list(range(len(clips))):
            fail(f"{label}: leased slots {[s.index for s in slots]}")
        t0 = time.perf_counter()
        n_push = 0
        for slot, clip in zip(slots, clips):
            for t in range(len(clip["y"]) if isinstance(clip, dict)
                           else len(clip)):
                if isinstance(clip, dict):
                    post_i420(f"{srv.url}slots/{slot.index}/", clip, t)
                else:
                    via(f"{label}: push", lambda: slot.push(clip[t]))
                n_push += 1
            via(f"{label}: close", slot.close_push)
        push_ms = 1e3 * (time.perf_counter() - t0) / n_push
        wall = run_pod(pod, [()] * len(clips), label)
        ticks = pod.metrics.dispatches
        m = via(f"{label}: GET /metrics", client.metrics)
        first = clips[0]
        first = ({k: v[0] for k, v in first.items()}
                 if isinstance(first, dict) else first[0])
        if m["frame_sig"] != frame_sig_json(first) or \
                m["frames_processed"] != pod.metrics.frames_processed:
            fail(f"{label}: /metrics frame_sig {m['frame_sig']}, "
                 f"expected {frame_sig_json(first)}")
        sizes = []
        for name in ("hue_matrix", "spectrum", "waveform", "input"):
            with stacks_on_stall(f"{label}: {name}.png"):
                status, png = http_json(
                    f"{srv.url}slots/{len(clips) - 1}/debug/{name}.png")
            want = 200 if name in slot_views else 404
            if status != want or (want == 200 and
                                  not png.startswith(b"\x89PNG")):
                fail(f"{label}: /slots/{len(clips) - 1}/debug/{name}.png "
                     f"answered {status}, expected {want}")
            sizes.append(f"{name} {status}")
        saved = via(f"{label}: GET /state.npz", client.save_state)
        ch = pod.cfg.channels
        for i, r in enumerate(ref):
            if i == 0 and record:
                pcm = via(f"{label}: audio.wav", lambda: slots[0].record(
                    len(r) / ch / pod.cfg.sample_rate)).reshape(-1)
                want = (np.clip(r, -1.0, 1.0) * 32767.0).astype("<i2")
                want = want.astype(np.float32) / 32767.0
            else:
                pcm, want = pod.pull(i, len(r)), r
            if not np.array_equal(pcm, want) or not np.abs(pcm).max() > 1e-3:
                fail(f"{label}: slot {i} differs from the in-process pod by "
                     f"{np.abs(pcm - want).max():.3e} or is silent")
        launches = read_counts()
    finally:
        srv.stop()
        pod.stop()
    want = {k: 0 for k in launches}
    want.update({k: n * ticks for k, n in need.items()})
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want} in {ticks} "
             f"ticks")
    frames = pod.metrics.frames_processed
    body = "raw I420" if isinstance(clips[0], dict) else ".npy RGB"
    recorded = " (slot 0 through /slots/0/audio.wav, quantised)"
    return launches, saved, (
        f"{ticks} ticks, {frames} real frames, {1e3 * wall / ticks:.3f} "
        f"ms/tick, {frames / wall:.1f} frames/s aggregate; one HTTP push of "
        f"a {body} body {push_ms:.3f} ms; launches {launches} (the HTTP "
        f"requests add none); each slot's PCM equal to the in-process pod's "
        f"bit for bit{recorded if record else ''}; /metrics frame_sig equal "
        f"to frame_sig_json; views {sizes} ({smi})")


def phase_pod_serve(frames: np.ndarray, yuv: dict, smi: str) -> dict:
    """The serving pod behind its HTTP panel at 1080p, driven by the port's
    PodClient: the flagship's live configuration with S = 4 leased slots
    per frame over .npy RGB bodies and in chunks of 8 over raw I420 bodies,
    and OrthoModes with S = 2 in chunks of 8, whose /state.npz after 8
    frames is POSTed into a second served pod that finishes the clips.
    Each against the in-process pod fed the same frames in the same ticks,
    bit for bit.  Returns the counts by path."""
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine
    cfg = live_config()
    shape = "x".join(map(str, frames.shape[1:3]))
    counts = {}

    def flagship(chunk):
        return lambda: MultiStreamAuralizer(
            cfg, n_streams=POD_S, engine=AuralizerEngine(cfg),
            chunk_frames=chunk)

    def in_process(make_pod, clips, label):
        pod = make_pod()
        run_pod(pod, [as_source(c) for c in clips], label)
        ch = pod.cfg.channels * pod.cfg.hop_size
        ref = [pod.pull(i, (len(c["y"]) if isinstance(c, dict) else len(c))
                        * ch) for i, c in enumerate(clips)]
        pod.stop()
        return ref

    for chunk, src, path, need in (
            (1, frames, "pod_serve_frame",
             {"mip_pool_u8": 1, "hann_peak_weighted_sum": 1,
              "vision_stats": 1, "agc_overlap_add": 1}),
            (LIVE_CHUNK, yuv, "pod_serve_yuv_chunk",
             {"mip_pool_yuv420_u8": 1, "hann_peak_weighted_sum": 1,
              "vision_stats": 1, "agc_overlap_add": 1})):
        clips = [clip_slice(src, POD_T * k, POD_T * (k + 1))
                 for k in range(POD_S)]
        clips[-1] = clip_slice(clips[-1], 0, 12)     # a dark slot at the end
        what = (f"flagship S={POD_S} {'YUV 4:2:0 ' if chunk > 1 else ''}"
                f"{shape} stereo chunk_frames={chunk}")
        ref = in_process(flagship(chunk), clips, f"{what} in process")
        counts[path], _, line = serve_pod_case(
            f"served {what}", flagship(chunk), clips, ref, need, smi,
            record=chunk == 1)
        say(f"pod serve: {what}: {line}")

    ocfg = ortho_config()
    oclips = [frames[POD_T * k:POD_T * (k + 1)] for k in range(2)]

    def ortho():
        eng = OrthoModesEngine(ocfg)
        return MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                                    chunk_frames=LIVE_CHUNK)
    what = (f"OrthoModes S=2 {shape} mip {ORTHO_MIP} mono "
            f"chunk_frames={LIVE_CHUNK}")
    ref = in_process(ortho, oclips, f"{what} in process")
    views = ("spectrum", "waveform", "input")
    need = {"mip_pool_u8": 1, "agc_overlap_add": 1}
    counts["ortho_pod_serve_chunk"], _, line = serve_pod_case(
        f"served {what}", ortho, oclips, ref, need, smi, slot_views=views)
    say(f"pod serve: {what}: {line}")
    half = POD_T // 2
    hop = ocfg.hop_size
    _, saved, _ = serve_pod_case(
        f"served {what}, first {half} frames", ortho,
        [c[:half] for c in oclips], [r[:half * hop] for r in ref], need, smi,
        slot_views=views)
    _, _, line = serve_pod_case(
        f"served {what}, restored from /state.npz", ortho,
        [c[half:] for c in oclips], [r[half * hop:] for r in ref], need, smi,
        state=saved, slot_views=views)
    say(f"pod serve: {what}: /state.npz ({len(saved)} B) after {half} "
        f"frames POSTed into a second served pod, which finishes the clips: "
        f"each slot's PCM equal to the uninterrupted in-process pod's bit "
        f"for bit; {line}")
    return counts


MESH_SHAPES = ((2, 1), (1, 2), (2, 2), (2, 4))
MESH_T = 8                       # ticks of each mesh step
TP_BAND = 3e-4                   # tests/test_parallel.py's band for TP
HOSTPOD_T = 8                    # frames a slot of the two-process pod
HOSTPOD_DEVICE = "cuda:0"        # each child process's device
NOT_SCALING = "one card, device repeated: not a scaling figure"


def repo_env(**extra) -> dict:
    """The environment of a child process: this one's, with the repository
    first on PYTHONPATH (the children load the kernels phase_build built,
    from the same build/ directory)."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def mesh_devices(k: int) -> list:
    """k devices for a mesh: distinct cards where the machine has k, else
    its cards repeated."""
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(k)]


def stream_rows(params: dict, n: int) -> dict:
    """Replicated live params as n rows, the stream-batched steps' form."""
    return {k: np.repeat(np.asarray(v, np.float32)[None], n, 0)
            for k, v in params.items()}


def mesh_launches(label: str, launches: dict, ticks: int, n_stream: int,
                  n_cell: int, kernels=("mip_pool_u8", "vision_stats",
                                        "hann_peak_weighted_sum")) -> None:
    """Fail unless a TP/DP tick launched each of ``kernels`` once a shard
    (n_stream * n_cell: the vision and the contraction run on every device
    of a row) and K4 once a stream row, and nothing else."""
    want = {k: 0 for k in launches}
    want.update({k: n_stream * n_cell * ticks for k in kernels})
    want["agc_overlap_add"] = n_stream * ticks
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want} in {ticks} "
             f"ticks")


def k2_mesh_entries(smi: str) -> list:
    """K2 at the widths of the TP step's cell shards, NP = 496/2 = 248 and
    496/4 = 124 (T = 2 streams of a shard, K = 4 stereo), against its plain
    version with phase_k2's checks."""
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.ops import spectrum_kernel as sk
    cfg = AuralizerConfig(sample_rate=48000.0)
    rng = np.random.default_rng(2)
    F, T, K = cfg.num_bins, 2, 4
    freqs = torch.as_tensor(cfg.bin_frequencies(), device="cuda")
    entries = []
    for NP, path in ((248, "mesh_2x2_frame"), (124, "mesh_2x4_frame")):
        pf = torch.as_tensor(rng.uniform(20, 20000, (T, NP)).astype(
            np.float32), device="cuda")
        scale = torch.as_tensor((rng.choice([1.0, 0.2], (T, NP))
                                 / cfg.bin_width).astype(np.float32),
                                device="cuda")
        w = torch.as_tensor(rng.normal(0, 0.1, (T, NP, K)).astype(
            np.float32), device="cuda")
        got = sk.hann_peak_weighted_sum(freqs, pf, scale, w)
        ref = sk.hann_peak_weighted_sum_plain(freqs, pf, scale, w)
        err = float((got - ref).abs().max())
        if got.shape != (T, F, K) or not err <= 1e-5:
            fail(f"K2 NP={NP} T={T}: shape {tuple(got.shape)}, differs "
                 f"from the plain version by {err:.3e}")
        check_batch_independent(
            f"K2 NP={NP}", lambda *a: (sk.hann_peak_weighted_sum(freqs, *a),),
            (pf, scale, w), T)
        e = entry(f"hann_peak_weighted_sum_np{NP}",
                  "vaudio_torch/csrc/spectrum_kernel.cu",
                  "vaudio/ops/spectrum_kernel.py:71", err,
                  lambda: sk.hann_peak_weighted_sum(freqs, pf, scale, w),
                  lambda: sk.hann_peak_weighted_sum_plain(freqs, pf, scale,
                                                          w),
                  nbytes=4 * (F + T * NP * (2 + K) + T * F * K),
                  ops=T * F * NP * (K2_PEAK_OPS + 2 * K), path=path,
                  counter="hann_peak_weighted_sum")
        say(f"K2 hann_peak_weighted_sum at a cell shard's width, T={T} "
            f"F={F} NP={NP} K={K}: max_abs_err {err:.3e}; frames 0 and T-1 "
            f"equal to T=1 calls and two calls equal, bit for bit; "
            f"{timing(e)}; {share(e)} ({smi})")
        entries.append(e)
    return entries


def phase_mesh(frames: np.ndarray, smi: str):
    """The local meshes of vaudio_torch.parallel over the card (its device
    repeated where it has fewer cards than shards) at the live
    configuration, S = 4 slots of 1080p: make_parallel_step on (2,1),
    (1,2), (2,2) and (2,4) for 8 ticks against the one-device batched
    step (DP bit for bit, TP within 3e-4, hues equal), its launches a tick
    and cell sums; make_parallel_chunk_step and OrthoModes'
    make_engine_parallel_step on (2,1) in chunks of 8; the mesh pod per
    frame on every shape and in chunks of 8 on (2,1) against the
    one-device pod; K2 at the cell shards' widths; dryrun_multichip(4).
    Returns (counts by path, the K2 entries)."""
    from vaudio_torch.config import LiveParams
    from vaudio_torch.parallel import (init_carry_batch, make_batched_step,
                                       make_engine_parallel_step,
                                       make_parallel_chunk_step,
                                       make_parallel_step, make_stream_mesh,
                                       sharding)
    from vaudio_torch.parallel.dryrun import dryrun_multichip
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import AuralizerEngine, OrthoModesEngine
    t_phase = time.perf_counter()
    cfg = live_config()
    params = LiveParams().as_arrays()
    S = POD_S
    clips = [frames[POD_T * k:POD_T * (k + 1)] for k in range(S)]
    shape = "x".join(map(str, frames.shape[1:3]))
    counts = {}

    def tick(t):
        return np.stack([c[t] for c in clips])

    def chunk(c):
        return np.stack([x[LIVE_CHUNK * c:LIVE_CHUNK * (c + 1)]
                         for x in clips])

    def mesh(n_stream, n_cell):
        return make_stream_mesh(n_stream, n_cell,
                                devices=mesh_devices(n_stream * n_cell))

    # -- the per-frame steps against the one-device batched step ---------
    one = make_batched_step(cfg)
    carry = init_carry_batch(cfg, S)
    ref = []
    for t in range(MESH_T):
        carry, out = one(carry, tick(t), params)
        ref.append(out["pcm"].cpu().numpy())
    ref_hues = carry.hues.cpu().numpy()
    for n_stream, n_cell in MESH_SHAPES:
        label = f"mesh ({n_stream},{n_cell}) make_parallel_step"
        step = make_parallel_step(cfg, mesh(n_stream, n_cell))
        torch.cuda.synchronize()
        reset_counts()
        sums = sharding.cell_reductions
        carry = init_carry_batch(cfg, S)
        got = []
        for t in range(MESH_T):
            carry, out = step(carry, tick(t), params)
            got.append(out["pcm"].numpy())
        launches = read_counts()
        sums = sharding.cell_reductions - sums
        mesh_launches(label, launches, MESH_T, n_stream, n_cell)
        if sums != (n_stream * MESH_T if n_cell > 1 else 0):
            fail(f"{label}: {sums} cell sums in {MESH_T} ticks")
        err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
        exact = all(np.array_equal(g, r) for g, r in zip(got, ref))
        if (n_cell == 1 and not exact) or not err <= TP_BAND:
            fail(f"{label}: PCM differs from the one-device step by "
                 f"{err:.3e} ({'bit for bit' if n_cell == 1 else TP_BAND} "
                 f"asked)")
        if not np.array_equal(carry.gather().hues.numpy(), ref_hues):
            fail(f"{label}: hues differ from the one-device step's")
        counts[f"mesh_{n_stream}x{n_cell}_frame"] = launches
        say(f"mesh: {label}, S={S} {shape} stereo, {MESH_T} ticks on "
            f"{mesh_devices(n_stream * n_cell)}: PCM "
            + ("equal to the one-device step bit for bit" if exact else
               f"within {err:.3e} of the one-device step (band {TP_BAND})")
            + f", hues equal; launches {launches}, {sums} cell sums "
            f"({smi})")

    # -- DP chunk step and the OrthoModes engine step on (2, 1) ----------
    eng = AuralizerEngine(cfg)
    one_chunk = eng.raw_chunk_step()
    stepc = make_parallel_chunk_step(cfg, mesh(2, 1))
    rows = stream_rows(params, S)
    carry_r, carry_m = init_carry_batch(cfg, S), init_carry_batch(cfg, S)
    ref, got = [], []
    for c in range(POD_T // LIVE_CHUNK):
        carry_r, out = one_chunk(carry_r, torch.as_tensor(chunk(c)).cuda(),
                                 rows)
        ref.append(out["pcm"].cpu().numpy())
    torch.cuda.synchronize()
    reset_counts()
    for c in range(POD_T // LIVE_CHUNK):
        carry_m, out = stepc(carry_m, chunk(c), params)
        got.append(out["pcm"].numpy())
    launches = read_counts()
    n_chunks = POD_T // LIVE_CHUNK
    mesh_launches("mesh (2,1) chunk step", launches, n_chunks, 2, 1)
    err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    if not err <= POD_BAND or not np.array_equal(
            carry_m.gather().hues.numpy(), carry_r.hues.cpu().numpy()):
        fail(f"mesh (2,1) make_parallel_chunk_step: PCM differs from the "
             f"one-device chunk step by {err:.3e} (band {POD_BAND}) or the "
             f"hues differ")
    counts["mesh_2x1_chunk"] = launches
    say(f"mesh: (2,1) make_parallel_chunk_step, {n_chunks} chunks of "
        f"{LIVE_CHUNK}: PCM within {err:.3e} of the one-device chunk step "
        f"(band {POD_BAND}), hues equal; launches {launches} ({smi})")

    ocfg = ortho_config()
    oeng = OrthoModesEngine(ocfg)
    oparams = oeng.params_arrays(LiveParams())
    ostep = make_engine_parallel_step(oeng, mesh(2, 1), chunk=True)
    ocarry_r = ocarry_m = oeng.init_carry_batch(S, clips[0][0])
    ref, got = [], []
    for c in range(n_chunks):
        ocarry_r, out = oeng.raw_chunk_step()(
            ocarry_r, torch.as_tensor(chunk(c)).cuda(),
            stream_rows(oparams, S))
        ref.append(out["pcm"].cpu().numpy())
    torch.cuda.synchronize()
    reset_counts()
    for c in range(n_chunks):
        ocarry_m, out = ostep(ocarry_m, chunk(c), oparams)
        got.append(out["pcm"].numpy())
    launches = read_counts()
    want = {k: 0 for k in launches}
    want.update(mip_pool_u8=2 * n_chunks, agc_overlap_add=2 * n_chunks)
    if launches != want or not all(np.array_equal(g, r)
                                   for g, r in zip(got, ref)):
        fail(f"mesh (2,1) OrthoModes engine step: launches {launches} "
             f"(expected {want}) or PCM not equal to the one-device engine "
             f"step bit for bit")
    counts["mesh_2x1_ortho_chunk"] = launches
    say(f"mesh: (2,1) make_engine_parallel_step OrthoModes mono mip "
        f"{ORTHO_MIP}, {n_chunks} chunks of {LIVE_CHUNK}: PCM equal to the "
        f"one-device engine step bit for bit; launches {launches} ({smi})")

    # -- the mesh pod against the one-device pod ---------------------------
    shared = LiveParams()

    def pod_run(mesh_shape, chunk_frames, n_frames=POD_T):
        pod = MultiStreamAuralizer(
            cfg, n_streams=S, params=shared, engine=AuralizerEngine(cfg),
            chunk_frames=chunk_frames,
            mesh=None if mesh_shape is None else mesh(*mesh_shape))
        wall = run_pod(pod, [c[:n_frames] for c in clips],
                       f"mesh pod {mesh_shape}")
        pcm = [pod.pull(i, n_frames * cfg.hop_size * 2) for i in range(S)]
        hues = pod.snapshot_carry().hues
        pod.stop()
        return pcm, hues, 1e3 * wall / pod.metrics.dispatches, \
            pod.metrics.dispatches

    ms = {}
    for chunk_frames, shapes in ((1, MESH_SHAPES), (LIVE_CHUNK, ((2, 1),))):
        pod_run(None, chunk_frames, LIVE_CHUNK)            # warm-up
        ref, ref_hues, ms[None, chunk_frames], _ = pod_run(None, chunk_frames)
        for mesh_shape in shapes:
            pod_run(mesh_shape, chunk_frames, LIVE_CHUNK)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            pcm, hues, ms[mesh_shape, chunk_frames], ticks = pod_run(
                mesh_shape, chunk_frames)
            launches = read_counts()
            label = f"mesh pod {mesh_shape} chunk_frames={chunk_frames}"
            mesh_launches(label, launches, ticks, *mesh_shape)
            err = max(float(np.abs(g - r).max()) for g, r in zip(pcm, ref))
            exact = all(np.array_equal(g, r) for g, r in zip(pcm, ref))
            band = POD_BAND if chunk_frames > 1 else TP_BAND
            if (chunk_frames == 1 and mesh_shape[1] == 1 and not exact) \
                    or not err <= band or not np.array_equal(hues, ref_hues) \
                    or not min(np.abs(g).max() for g in pcm) > 1e-3:
                fail(f"{label}: a slot differs from the one-device pod's by "
                     f"{err:.3e} (band {band}), its hues differ, or it is "
                     f"silent")
            path = f"mesh_pod_{mesh_shape[0]}x{mesh_shape[1]}_" + (
                "frame" if chunk_frames == 1 else "chunk")
            counts[path] = launches
            say(f"mesh: {label}, S={S} {shape} stereo, {POD_T} frames a "
                f"slot: every slot "
                + ("equal to the one-device pod's bit for bit" if exact
                   else f"within {err:.3e} of the one-device pod's")
                + f", hues equal; launches {launches} in {ticks} ticks "
                f"({smi})")
    for mesh_shape in ((2, 1), (2, 2)):
        rows, wall_ms = profiled(lambda: pod_run(mesh_shape, 1))
        say(pod_profile_line(f"mesh pod {mesh_shape} chunk_frames=1 "
                             f"({NOT_SCALING})", rows, wall_ms, POD_T, smi))
    say("mesh: pod ms a tick in this run (" + NOT_SCALING + "): "
        + "; ".join(f"{'one device' if k[0] is None else k[0]} "
                    f"chunk_frames={k[1]} {v:.3f}" for k, v in ms.items())
        + f" ({smi})")

    entries = k2_mesh_entries(smi)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as line:
        dryrun_multichip(4)
    say(f"mesh: {line.getvalue().strip()} in "
        f"{time.perf_counter() - t0:.1f} s; the phase "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    return counts, entries


def phase_hostpod(frames: np.ndarray, smi: str) -> dict:
    """Two child processes on the card run tests/torch_hostpod_driver.py:
    one 4-slot global MultiHostPod at the live configuration, 8 frames of
    1080p a slot, per frame and in chunks of 8, joined through
    torch.distributed on Gloo (host flags), each child's device cuda:0.
    Every global slot against the single-process pod (bit for bit per
    frame, within 2e-6 in chunks), each child's launches a tick; then a
    world-of-one MultiHostAuralizer through init_distributed.  The
    children get the watchdog's remaining time and are killed past it.
    Returns the counts by path (both children's launches)."""
    from vaudio_torch.config import AuralizerConfig, LiveParams
    from vaudio_torch.parallel import (MultiHostAuralizer, init_distributed,
                                       make_multihost_mesh)
    from vaudio_torch.runtime import MultiStreamAuralizer, chunked
    from vaudio_torch.runtime.engine import AuralizerEngine
    t_phase = time.perf_counter()
    cfg = live_config()
    default = AuralizerConfig()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if getattr(cfg, f.name) != getattr(default, f.name)}
    S, T = POD_S, HOSTPOD_T
    clips = np.stack([frames[POD_T * k:POD_T * k + T] for k in range(S)])
    root = Path(__file__).resolve().parent
    env = repo_env()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/clips.npy", clips)
        for chunk_frames, path in ((1, "hostpod_frame"),
                                   (LIVE_CHUNK, "hostpod_chunk")):
            pod = MultiStreamAuralizer(cfg, n_streams=S,
                                       engine=AuralizerEngine(cfg),
                                       chunk_frames=chunk_frames)
            run_pod(pod, list(clips), "single-process pod")
            ref = [pod.pull(i, T * cfg.hop_size * 2) for i in range(S)]
            pod.stop()
            out = f"{tmp}/out{chunk_frames}"
            os.mkdir(out)
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            limit = max(30.0, min(300.0, _deadline - time.monotonic() - 30))
            t0 = time.perf_counter()
            procs = [spawn(
                [sys.executable, str(root / "tests/torch_hostpod_driver.py"),
                 str(pid), "2", str(port), f"{tmp}/clips.npy", out,
                 "--device", HOSTPOD_DEVICE, "--chunk", str(chunk_frames),
                 "--config", json.dumps(fields), "--timeout", str(limit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=root) for pid in (0, 1)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(
                        timeout=max(1.0, limit + 10 - (time.perf_counter()
                                                       - t0)))[0])
            except subprocess.TimeoutExpired:
                fail(f"hostpod chunk_frames={chunk_frames}: a child still "
                     f"runs after {limit:.0f} s")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            for pid, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    fail(f"hostpod chunk_frames={chunk_frames}: process "
                         f"{pid} exited {p.returncode}:\n{log[-3000:]}")
            infos = [json.loads(Path(f"{out}/proc_{pid}.json").read_text())
                     for pid in (0, 1)]
            errs = []
            for g in range(S):
                got = np.load(f"{out}/pcm_{g}.npy")
                err = float(np.abs(got - ref[g]).max())
                if (chunk_frames == 1 and not np.array_equal(got, ref[g])) \
                        or not err <= POD_BAND \
                        or not np.abs(got).max() > 1e-3:
                    fail(f"hostpod chunk_frames={chunk_frames}: global slot "
                         f"{g} differs from the single-process pod by "
                         f"{err:.3e} or is silent")
                errs.append(err)
            for pid, info in enumerate(infos):
                want = {k: info["ticks"] for k in info["launches"]}
                if info["slots"] != [2 * pid, 2 * pid + 2] or \
                        info["launches"] != want:
                    fail(f"hostpod chunk_frames={chunk_frames}: process "
                         f"{pid} served {info['slots']} with launches "
                         f"{info['launches']} in {info['ticks']} ticks")
            counts[path] = {k: 0 for k in kernel_modules()}
            for info in infos:
                for k, n in info["launches"].items():
                    counts[path][k] += n
            say(f"hostpod: two processes on {torch.cuda.get_device_name(0)}"
                f" (Gloo on 127.0.0.1, {HOSTPOD_DEVICE} each), a 4-slot "
                f"global pod, "
                f"{T} frames of {'x'.join(map(str, clips.shape[2:4]))} a "
                f"slot, chunk_frames={chunk_frames}: every global slot "
                + ("equal to the single-process pod's bit for bit"
                   if chunk_frames == 1 else
                   f"within {max(errs):.3e} of the single-process pod's "
                   f"(band {POD_BAND})")
                + f"; each process {infos[0]['ticks']} ticks, K1-K4 once a "
                f"tick, ms a tick {infos[0]['ms_per_tick']:.3f} / "
                f"{infos[1]['ms_per_tick']:.3f} ({NOT_SCALING}); "
                f"{wall:.1f} s with the processes' start ({smi})")
    n = init_distributed()
    if n != 1:
        fail(f"init_distributed() outside torchrun gave {n} processes")
    mh = MultiHostAuralizer(cfg, S, params=LiveParams().as_arrays(),
                            mesh=make_multihost_mesh(devices=mesh_devices(2)))
    local = mh.local_audio(mh.step(clips))
    err = 0.0
    for g in range(S):
        ref, _, _ = chunked.run_offline_batched(clips[g], cfg, chunk=T,
                                                device="cuda")
        err = max(err, float(np.abs(local[g] - ref.cpu().numpy()).max()))
    if not err <= POD_BAND:
        fail(f"MultiHostAuralizer (world of one): differs from "
             f"run_offline_batched by {err:.3e}")
    say(f"hostpod: init_distributed() = 1 outside torchrun; a world-of-one "
        f"MultiHostAuralizer over {mesh_devices(2)}, one chunk of {T}: "
        f"within {err:.3e} of run_offline_batched (band {POD_BAND}); the "
        f"phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return counts


# ---------------------------------------------------------------------------
# The command line, in processes of its own
# ---------------------------------------------------------------------------

CLI_T = 64                       # frames of the CLI's sonify and stream runs
CLI_TRACE_T = 16                 # frames of the traced stream
CLI_POD_S = 4                    # slots of the CLI's pod
CLI_POD_T = 16                   # frames a slot of the CLI's pod
CLI_SERVE_T = 16                 # frames pushed into the served pod
CLI_HOSTPOD_T = 8                # frames a slot of the two-process CLI pod
CLI_FLAGS = ["--sample-rate", "48000", "--channels", "2", "--pallas"]
# A CLI process that counts its kernel launches: ``python -c CLI_PRELUDE
# <info.json> <command> ...`` times the start-up (the imports, the CUDA
# context, loading the kernel library phase_build built), runs the package's
# __main__ as ``python -m vaudio_torch <command> ...`` does (runpy), and at
# exit writes the start-up, the command's seconds and the launch counts to
# info.json.
CLI_PRELUDE = """
import atexit, json, runpy, sys, time
t0 = time.perf_counter()
import torch
import vaudio_torch.cli
from chip_smoke import read_counts
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
from vaudio_torch.ops import _build
_build.lib()
t3 = time.perf_counter()
info = {"import_s": t1 - t0, "cuda_s": t2 - t1, "kernels_s": t3 - t2}
path = sys.argv.pop(1)


def dump():
    info["command_s"] = time.perf_counter() - t3
    info["launches"] = read_counts()
    with open(path, "w") as f:
        json.dump(info, f)


atexit.register(dump)
sys.argv[0] = "vaudio_torch"
runpy.run_module("vaudio_torch", run_name="__main__", alter_sys=True)
"""


def start_cli(args: list, info: str = None, env: dict = None,
              **kw) -> subprocess.Popen:
    """``python -m vaudio_torch <args>`` from the repository's root, on the
    card (no VAUDIO_PLATFORM), with ``env``'s variables added; with
    ``info``, through CLI_PRELUDE."""
    env = repo_env(**(env or {}))
    env.pop("VAUDIO_PLATFORM", None)
    cmd = ([sys.executable, "-c", CLI_PRELUDE, info, *args] if info
           else [sys.executable, "-m", "vaudio_torch", *args])
    kw.setdefault("stdout", subprocess.PIPE)
    kw.setdefault("stderr", subprocess.PIPE)
    return spawn(cmd, env=env, cwd=Path(__file__).resolve().parent, **kw)


def finish_cli(proc: subprocess.Popen, what: str, info: str = None):
    """Wait for a CLI process (within the watchdog's remaining time): its
    stdout bytes, its stderr text and its info (CLI_PRELUDE's), failing the
    run unless it exits 0."""
    limit = max(30.0, _deadline - time.monotonic() - 30)
    try:
        out, err = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"cli {what}: still running after {limit:.0f} s")
    err = err.decode(errors="replace") if isinstance(err, bytes) else err
    if proc.returncode != 0:
        fail(f"cli {what}: exit {proc.returncode}:\n{(err or '')[-3000:]}")
    return out, err, (json.loads(Path(info).read_text()) if info else None)


def run_cli(args: list, what: str, info: str = None):
    """start_cli + finish_cli: (stdout, stderr, info, wall s)."""
    t0 = time.perf_counter()
    out, err, inf = finish_cli(start_cli(args, info), what, info)
    return out, err, inf, time.perf_counter() - t0


def cli_launches(what: str, got: dict, want: dict) -> dict:
    """Fail unless a CLI process launched exactly ``want`` (0 elsewhere)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        fail(f"cli {what}: launches {got}, expected {full}")
    return got


def startup(info: dict) -> str:
    total = info["import_s"] + info["cuda_s"] + info["kernels_s"]
    return (f"start-up {total:.2f}"
            f" s (import {info['import_s']:.2f}, CUDA context "
            f"{info['cuda_s']:.2f}, kernel load {info['kernels_s']:.3f})")


def stream_metrics(err: str, what: str) -> dict:
    """The metrics dict of a ``stream`` command's last stderr line."""
    import ast
    m = re.search(r"metrics: (\{.*\})", err)
    if m is None:
        fail(f"cli {what}: no metrics line on stderr:\n{err[-2000:]}")
    return ast.literal_eval(m.group(1))


def wav_bytes_equal(a: str, b: str) -> bool:
    return Path(a).read_bytes() == Path(b).read_bytes()


def phase_cli(frames: np.ndarray, smi: str) -> dict:
    """The command line (``python -m vaudio_torch``) on the card at 1080p
    and 48 kHz, each command a process of its own with the repository on
    PYTHONPATH, using the kernels phase_build built: sonify (stereo, and
    OrthoModes mono), stream in pipe mode per frame and in chunks of 8, a
    traced stream, the pod with 4 file slots, the served pod fed by the push
    command and read by the pull command, two pod --coordinator processes
    on Gloo, doctor --json and info.  Each result against the port in this
    process on the same frames (bit for bit where the issue asks it), each
    command's launches, wall time, start-up and ms/frame beside the
    in-process figure.  Returns the counts by path."""
    from vaudio_torch import cli
    from vaudio_torch.api import Auralizer
    from vaudio_torch.client import PodClient
    from vaudio_torch.io import write_wav
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import AuralizerEngine
    from vaudio_torch.utils.profiling import trace_kernel_counts
    t_phase = time.perf_counter()
    H, W = frames.shape[1:3]
    size = f"{H}x{W}"
    card = torch.cuda.get_device_name(0)
    counts = {}

    def config(argv):
        return cli._build_config(cli.build_parser().parse_args(argv))

    with tempfile.TemporaryDirectory() as tmp:
        clip = np.ascontiguousarray(frames[:CLI_T])
        np.save(f"{tmp}/clip.npy", clip)
        clip.tofile(f"{tmp}/clip.rgb")

        # -- sonify: stereo through K1, K2 and K4; OrthoModes mono ------------
        for path, model, flags in (
                ("cli_sonify", "auralizer", CLI_FLAGS),
                ("cli_sonify_ortho", "orthomodes",
                 ["--sample-rate", "48000", "--model", "orthomodes"])):
            argv = ["sonify", f"{tmp}/clip.npy", "-o", f"{tmp}/{path}.wav",
                    *flags]
            _, _, info, wall = run_cli(argv, path, f"{tmp}/{path}.json")
            cfg, params = config(argv)
            aur = Auralizer(config=cfg, params=params, model=model,
                            device="cuda")
            aur.sonify(clip[:8])                         # warm-up
            t0 = time.perf_counter()
            aur.sonify_to_wav(clip, f"{tmp}/{path}_ref.wav")
            inproc = 1e3 * (time.perf_counter() - t0) / CLI_T
            if not wav_bytes_equal(f"{tmp}/{path}.wav",
                                   f"{tmp}/{path}_ref.wav"):
                fail(f"cli {path}: the WAV differs from the in-process "
                     f"sonify_to_wav's")
            want = {"mip_pool_u8": 1, "agc_overlap_add": 1}
            if model == "auralizer":
                want["hann_peak_weighted_sum"] = 1
            counts[path] = cli_launches(path, info["launches"], want)
            say(f"cli: python -m vaudio_torch sonify {' '.join(flags)} "
                f"({CLI_T} u8 frames {size} .npy, {aur.config.channels} "
                f"channel(s)): WAV equal to the in-process sonify_to_wav's "
                f"bit for bit; launches {info['launches']}; wall "
                f"{wall:.2f} s, {startup(info)}, command "
                f"{1e3 * info['command_s'] / CLI_T:.3f} ms/frame (.npy read, "
                f"first dispatch and WAV write included), in process "
                f"{inproc:.3f} ms/frame ({smi})")

        # -- stream in pipe mode, per frame and in chunks of 8 ----------------
        for chunk, path in ((1, "cli_stream"),
                            (LIVE_CHUNK, "cli_stream_chunk")):
            log = f"{tmp}/{path}.jsonl"
            argv = ["stream", "--size", size, "--input", f"{tmp}/clip.rgb",
                    *CLI_FLAGS, "--chunk-frames", str(chunk),
                    "--metrics-log", log]
            out, err, info, wall = run_cli(argv, path, f"{tmp}/{path}.json")
            got = np.frombuffer(out, "<f4")
            m = stream_metrics(err, path)
            if m["frames_processed"] != CLI_T or m["dropped_frames"]:
                fail(f"cli {path}: {m}")
            pattern = [json.loads(line)["frames"]
                       for line in Path(log).read_text().splitlines()]
            cfg, params = config(argv)
            if sum(pattern) != CLI_T or (chunk == 1 and set(pattern) != {1}):
                fail(f"cli {path}: dispatch pattern {pattern}")
            ref = offline_by_pattern(clip, pattern, cfg)
            if not np.array_equal(got, ref):
                fail(f"cli {path}: stdout's PCM ({got.size} samples) differs "
                     f"from the in-process run with the same dispatches")
            n = len(pattern)
            counts[path] = cli_launches(path, info["launches"], {
                "mip_pool_u8": n, "hann_peak_weighted_sum": n,
                "agc_overlap_add": n})
            live = Auralizer(source=clip, config=dataclasses.replace(
                cfg, ring_buffer_frames=CLI_T + 8), params=params,
                device="cuda", chunk_frames=chunk)
            t0 = time.perf_counter()
            live.run_until_exhausted(timeout=300)
            inproc = 1e3 * (time.perf_counter() - t0) / CLI_T
            say(f"cli: python -m vaudio_torch stream --chunk-frames {chunk} "
                f"({CLI_T} frames {size} rgb24 from a file, stereo 48 kHz, "
                f"--pallas): stdout's f32 PCM equal to the in-process run "
                f"with the stream's {n} dispatches bit for bit; launches "
                f"{info['launches']}; latency p50 {m['latency_p50_ms']:.3f} "
                f"ms p99 {m['latency_p99_ms']:.3f} ms; wall {wall:.2f} s, "
                f"{startup(info)}, command "
                f"{1e3 * info['command_s'] / CLI_T:.3f} ms/frame, in "
                f"process {inproc:.3f} ms/frame ({smi})")

        # -- a traced stream: the trace shows the kernels ---------------------
        clip[:CLI_TRACE_T].tofile(f"{tmp}/trace.rgb")
        argv = ["stream", "--size", size, "--input", f"{tmp}/trace.rgb",
                *CLI_FLAGS, "--trace", f"{tmp}/trace"]
        out, err, _, wall = run_cli(argv, "stream --trace")
        traced = trace_kernel_counts(f"{tmp}/trace", (
            "mip_pool_u8", "hann_peak", "agc_overlap_add", "vision_stats"))
        want = {"mip_pool_u8": CLI_TRACE_T, "hann_peak": CLI_TRACE_T,
                "agc_overlap_add": CLI_TRACE_T, "vision_stats": 0}
        if traced != want:
            fail(f"cli stream --trace: kernels in the trace {traced}, "
                 f"expected {want}")
        cfg, _ = config(argv)
        if not np.array_equal(np.frombuffer(out, "<f4"), offline_by_pattern(
                clip[:CLI_TRACE_T], [1] * CLI_TRACE_T, cfg)):
            fail("cli stream --trace: stdout's PCM differs from the "
                 "in-process run")
        trace_mb = sum(f.stat().st_size for f in Path(f"{tmp}/trace")
                       .glob("*")) / 1e6
        say(f"cli: python -m vaudio_torch stream --trace ({CLI_TRACE_T} "
            f"frames {size}): the torch.profiler trace ({trace_mb:.1f} MB) "
            f"shows K1 mip_pool_u8, K2' hann_peak and K4 agc_overlap_add "
            f"{CLI_TRACE_T} times each, K3 0; PCM equal to the in-process "
            f"run; wall {wall:.2f} s ({smi})")

        # -- the pod: 4 raw rgb24 file slots, per frame -----------------------
        argv = ["pod", "--size", size, *CLI_FLAGS, "-o", f"{tmp}/pod"]
        pclips = []
        for k in range(CLI_POD_S):
            c = np.ascontiguousarray(frames[CLI_POD_T * k:CLI_POD_T * (k + 1)])
            c.tofile(f"{tmp}/slot{k}.rgb")
            argv += ["--input", f"{tmp}/slot{k}.rgb"]
            pclips.append(c)
        _, err, info, wall = run_cli(argv, "pod", f"{tmp}/cli_pod.json")
        ticks = int(re.search(r"in (\d+) dispatches", err).group(1))
        cfg, params = config(argv)
        pod = MultiStreamAuralizer(
            cfg, n_streams=CLI_POD_S, engine=AuralizerEngine(cfg),
            params=[dataclasses.replace(params) for _ in range(CLI_POD_S)])
        inproc = 1e3 * run_pod(pod, [iter(c) for c in pclips],
                               "in-process pod") / CLI_POD_T
        for i in range(CLI_POD_S):
            write_wav(f"{tmp}/pod_ref{i}.wav",
                      pod.pull(i, CLI_POD_T * cfg.hop_size * 2).reshape(-1, 2),
                      cfg.sample_rate, channels=2)
            if not wav_bytes_equal(f"{tmp}/pod/slot{i}.wav",
                                   f"{tmp}/pod_ref{i}.wav"):
                fail(f"cli pod: slot{i}.wav differs from the in-process "
                     f"pod's slot")
        pod.stop()
        if ticks != CLI_POD_T:
            fail(f"cli pod: {ticks} dispatches for {CLI_POD_T} frames a slot")
        counts["cli_pod"] = cli_launches("pod", info["launches"], {
            "mip_pool_u8": ticks, "hann_peak_weighted_sum": ticks,
            "agc_overlap_add": ticks})
        say(f"cli: python -m vaudio_torch pod, {CLI_POD_S} raw rgb24 file "
            f"slots of {CLI_POD_T} frames {size}, stereo 48 kHz, per frame: "
            f"every slotN.wav equal to the in-process pod's bit for bit; "
            f"launches {info['launches']} in {ticks} ticks; wall "
            f"{wall:.2f} s, {startup(info)}, command "
            f"{1e3 * info['command_s'] / CLI_POD_T:.3f} ms a tick, in "
            f"process {inproc:.3f} ms a tick ({smi})")

        # -- the served pod: push and pull commands ---------------------------
        serve_clip = np.ascontiguousarray(frames[:CLI_SERVE_T])
        np.save(f"{tmp}/push.npy", serve_clip)
        t0 = time.perf_counter()
        server = start_cli(["pod", "--size", size, *CLI_FLAGS, "--input",
                            "push", "--input", "push:dark", "--serve",
                            "127.0.0.1:0", "-o", f"{tmp}/served"],
                           f"{tmp}/cli_serve.json", stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
        lines = []
        for line in server.stderr:           # until the panel's address
            lines.append(line)
            url = re.search(r"live panel at (http://\S+)", line)
            if url or time.perf_counter() - t0 > 300:
                break
        if not url:
            server.kill()
            fail(f"cli pod --serve: no panel address:\n{''.join(lines)}")
        url = url.group(1).rstrip("/")
        drain = threading.Thread(target=lambda: lines.extend(server.stderr),
                                 daemon=True)
        drain.start()
        pull = start_cli(["pull", "--url", url, "--slot", "0", "--seconds",
                          "0.2", "-o", f"{tmp}/pulled.wav"])
        _, push_err, _ = finish_cli(start_cli(
            ["push", "--url", url, "--slot", "0", "--input",
             f"{tmp}/push.npy", "--maxsize", str(CLI_SERVE_T)]), "push")
        if f"push: {CLI_SERVE_T} frames -> {url} slot 0" not in push_err:
            fail(f"cli push: {push_err[-2000:]}")
        finish_cli(pull, "pull")
        client = PodClient(url)
        m = via("GET /metrics", client.metrics)
        door = m["slots"][0]["push"]
        if any(s["failed"] for s in m["slots"]) or \
                door["pushed"] != CLI_SERVE_T or door["dropped"]:
            fail(f"cli pod --serve: a slot failed, or slot 0's door took "
                 f"other than {CLI_SERVE_T} frames: {m['slots']}")
        via("close slot 1's push door", client.slot(1).close_push)
        server.wait(timeout=max(30.0, _deadline - time.monotonic() - 30))
        drain.join(timeout=30)
        if server.returncode != 0:
            fail(f"cli pod --serve: exit {server.returncode}:\n"
                 f"{''.join(lines)[-3000:]}")
        wall = time.perf_counter() - t0
        info = json.loads(Path(f"{tmp}/cli_serve.json").read_text())
        err = "".join(lines)
        ticks = int(re.search(r"in (\d+) dispatches", err).group(1))
        pulled, _ = read_wav_checked(f"{tmp}/pulled.wav", "pull")
        slot0, _ = read_wav_checked(f"{tmp}/served/slot0.wav", "slot0.wav")
        if len(pulled) != round(0.2 * 48000) or not len(slot0):
            fail(f"cli pod --serve: pulled {len(pulled)} samples, slot0.wav "
                 f"{len(slot0)}")
        counts["cli_serve"] = cli_launches("pod --serve", info["launches"], {
            "mip_pool_u8": ticks, "hann_peak_weighted_sum": ticks,
            "agc_overlap_add": ticks})
        say(f"cli: python -m vaudio_torch pod --serve with a push and a "
            f"push:dark slot, fed by python -m vaudio_torch push "
            f"({CLI_SERVE_T} "
            f".npy frames {size}) and read by pull (0.2 s of slot 0): exit "
            f"0, no slot failed, the WAVs finite and non-empty; launches "
            f"{info['launches']} in {ticks} ticks (a held push slot ticks "
            f"at device speed); wall {wall:.2f} s, {startup(info)} ({smi})")

        # -- two pod --coordinator processes on Gloo --------------------------
        gclips = [np.ascontiguousarray(
            frames[CLI_POD_T * g:CLI_POD_T * g + CLI_HOSTPOD_T])
            for g in range(CLI_POD_S)]
        for g, c in enumerate(gclips):
            np.save(f"{tmp}/g{g}.npy", c)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [start_cli(
            ["pod", "--size", size, *CLI_FLAGS, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
             str(pid), "-o", f"{tmp}/host{pid}",
             "--input", f"{tmp}/g{2 * pid}.npy",
             "--input", f"{tmp}/g{2 * pid + 1}.npy"],
            f"{tmp}/cli_host{pid}.json") for pid in (0, 1)]
        done = [finish_cli(p, f"pod --coordinator process {pid}",
                           f"{tmp}/cli_host{pid}.json")
                for pid, p in enumerate(procs)]
        infos = [d[2] for d in done]
        ticks = [int(re.search(r"in (\d+) dispatches", d[1]).group(1))
                 for d in done]
        wall = time.perf_counter() - t0
        cfg, params = config(["pod", "--size", size, *CLI_FLAGS])
        pod = MultiStreamAuralizer(
            cfg, n_streams=CLI_POD_S, engine=AuralizerEngine(cfg),
            params=[dataclasses.replace(params) for _ in range(CLI_POD_S)])
        run_pod(pod, [iter(c) for c in gclips], "in-process pod")
        for g in range(CLI_POD_S):
            write_wav(f"{tmp}/host_ref{g}.wav",
                      pod.pull(g, CLI_HOSTPOD_T * cfg.hop_size * 2)
                      .reshape(-1, 2), cfg.sample_rate, channels=2)
            if not wav_bytes_equal(f"{tmp}/host{g // 2}/slot{g % 2}.wav",
                                   f"{tmp}/host_ref{g}.wav"):
                fail(f"cli pod --coordinator: global slot {g} differs from "
                     f"the single-process pod's")
        pod.stop()
        counts["cli_hostpod"] = {k: sum(i["launches"][k] for i in infos)
                                 for k in infos[0]["launches"]}
        for pid, (i, n) in enumerate(zip(infos, ticks)):
            # The lockstep pod's last tick is the all-dark one on which its
            # sources end (ROADMAP queue 3): it launches like any other.
            if n != CLI_HOSTPOD_T + 1:
                fail(f"cli pod --coordinator process {pid}: {n} ticks")
            cli_launches(f"pod --coordinator process {pid}", i["launches"],
                         {"mip_pool_u8": n, "hann_peak_weighted_sum": n,
                          "agc_overlap_add": n})
        say(f"cli: two python -m vaudio_torch pod --coordinator processes "
            f"on {card} (Gloo on 127.0.0.1), 2 slots of {CLI_HOSTPOD_T} "
            f".npy frames {size} each: every global slot's WAV equal to the "
            f"single-process pod's bit for bit; launches "
            f"{[i['launches'] for i in infos]}; wall {wall:.2f} s for both, "
            f"{startup(infos[0])} / {startup(infos[1])} ({smi})")

        # -- doctor --json and info, both at once -----------------------------
        t0 = time.perf_counter()
        doctor = start_cli(["doctor", "--json"])
        info_p = start_cli(["info"])
        out, _, _ = finish_cli(doctor, "doctor --json")
        checks = {c["name"]: c for c in json.loads(out)}
        bad = [c for c in checks.values() if c["status"] == "fail"]
        if bad or card not in checks["backend"]["detail"] or \
                checks["kernels"]["status"] != "ok" or \
                checks["smoke"]["status"] != "ok" or \
                not checks["smoke"]["detail"].endswith("(cuda)"):
            fail(f"cli doctor --json: {list(checks.values())}")
        out, _, _ = finish_cli(info_p, "info")
        info = json.loads(out)
        if info["device"] != "cuda" or not any(card in d for d in
                                               info["devices"]):
            fail(f"cli info: {info['device']} {info['devices']}")
        say(f"cli: python -m vaudio_torch doctor --json: no fail "
            f"({', '.join(f'{k} {c['status']}' for k, c in checks.items())}"
            f"), backend {checks['backend']['detail']}; info names "
            f"{info['devices']} (torch {info['torch']}, CUDA "
            f"{info['cuda']}); both {time.perf_counter() - t0:.2f} s "
            f"({smi})")
    say(f"cli: the phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return counts


def read_wav_checked(path: str, what: str):
    from vaudio_torch.io import read_wav
    audio, sr = read_wav(path)
    if not np.isfinite(audio).all():
        fail(f"cli {what}: {path} is not finite")
    return audio, sr


def phase_entry(frames: np.ndarray, smi: str) -> None:
    """vaudio_torch.entry.entry() on the card: its fn on its 1080p example
    inputs and on a structured frame gives pcm f32[2048], finite, equal bit
    for bit to frame_step through make_step on the same carry; its ms a
    call from CUDA events."""
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.entry import entry
    from vaudio_torch.runtime import step
    fn, (carry, frame, params) = entry()
    if frame.device.type != "cuda" or carry.phases.device.type != "cuda":
        fail(f"entry(): example inputs on {frame.device}")
    ref_step = step.make_step(AuralizerConfig(), device="cuda")
    ref_carry = carry
    for k, f in enumerate((frame, torch.as_tensor(frames[0], device="cuda"))):
        carry, out = fn(carry, f, params)
        ref_carry, ref = ref_step(ref_carry, f, params)
        pcm = out["pcm"]
        if pcm.dtype != torch.float32 or pcm.shape != (2048,) or \
                not bool(torch.isfinite(pcm).all()):
            fail(f"entry(): frame {k}: pcm {pcm.dtype} {tuple(pcm.shape)}")
        if not bits_equal(pcm, ref["pcm"]) or \
                not torch.equal(carry.hues, ref_carry.hues):
            fail(f"entry(): frame {k}: differs from frame_step")
    peak = float(pcm.abs().max())
    ms = cuda_ms(lambda: fn(carry, f, params))
    say(f"entry: vaudio_torch.entry.entry() on {torch.cuda.get_device_name(0)}"
        f": fn(carry, frame, params) on its 1080p example inputs and a "
        f"structured 1080p u8 frame gives pcm f32[2048], finite (peak "
        f"{peak:.4f}), equal bit for bit to frame_step; {ms:.3f} ms a call "
        f"(CUDA events, host launch gaps included) ({smi})")


ORACLE_T = 4                     # 1080p frames the oracle phase holds to f64
PARITY_FRAMES, PARITY_SIZE = 3, 128  # the parity command's default input
# The literal f64 oracle in a child process, numpy on one host core:
# ``python -c ORACLE_CHILD <clip.npy> <out.npz>`` runs
# vaudio_torch.utils.parity.reference_pipeline on the clip (the port's
# oracle_input of it) and writes its four results and its seconds.  It ends
# itself when its parent is gone.
ORACLE_CHILD = """
import os, sys, threading, time
import numpy as np
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.utils.parity import oracle_input, reference_pipeline
parent = os.getppid()


def orphaned():
    while os.getppid() == parent:
        time.sleep(1)
    os._exit(1)


threading.Thread(target=orphaned, daemon=True).start()
clip, out = sys.argv[1:3]
t0 = time.perf_counter()
ref = reference_pipeline(oracle_input(np.load(clip)), AuralizerConfig())
np.savez(out, *ref, seconds=time.perf_counter() - t0)
"""
TPU_AUDIT = "benchmarks/TPU_PARITY_r05.json"
# The TPU audit's stage beside each stage of the port's audit that has one.
TPU_STAGE = {"mip_k1": "mip_pallas_kernel", "mip_planes_k1":
             "mip_u8_int8_path", "histogram_k3": "hue_histogram_tiled",
             "contraction_k2": "spectrum_contraction"}


def parity_input() -> np.ndarray:
    """The parity command's input (vaudio_torch/cli.py, cmd_parity), the
    JAX harness's own: seeded uniform f32 frames."""
    return np.random.default_rng(0).uniform(
        0, 1, (PARITY_FRAMES, PARITY_SIZE, PARITY_SIZE, 3)).astype(
            np.float32)


def start_oracles(clips: dict) -> dict:
    """The literal oracle on each clip, each in a child process of its own
    (ORACLE_CHILD) started now, while the GPU phases run; phase_oracle
    reads them.  At exit every child still running is killed and the work
    directory removed."""
    import shutil
    work = Path(tempfile.mkdtemp(prefix="vaudio_oracle_"))
    jobs = {}
    for name, clip in clips.items():
        np.save(work / f"{name}.npy", clip)
        jobs[name] = spawn(
            [sys.executable, "-c", ORACLE_CHILD, str(work / f"{name}.npy"),
             str(work / f"{name}.npz")], env=repo_env(),
            cwd=Path(__file__).resolve().parent, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)

    def stop():
        for proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    atexit.register(stop)
    return {"procs": jobs, "work": work, "stop": stop}


def finish_oracle(jobs: dict, name: str):
    """(the oracle's four results, its seconds in the child, the seconds
    waited for it here), failing the run unless the child exits 0 within
    the watchdog's remaining time."""
    proc = jobs["procs"][name]
    t0 = time.perf_counter()
    limit = max(30.0, _deadline - time.monotonic() - 30)
    try:
        _, err = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        jobs["stop"]()
        fail(f"oracle {name}: still running after {limit:.0f} s")
    if proc.returncode != 0:
        fail(f"oracle {name}: exit {proc.returncode}:\n"
             f"{err.decode(errors='replace')[-3000:]}")
    with np.load(jobs["work"] / f"{name}.npz") as z:
        ref = tuple(z[f"arr_{i}"] for i in range(4))
        seconds = float(z["seconds"])
    return ref, seconds, time.perf_counter() - t0


def phase_oracle(frames: np.ndarray, jobs: dict, smi: str) -> dict:
    """The port against the reference's literal f64 math on the card
    (vaudio_torch.utils.parity): (a) the parity command's input, 3 f32
    frames of 128^2 at AuralizerConfig(), through the per-frame runner (K2'
    only: the f32 frames take the matmul mip, K3 and K4 are off); (b) the
    first ORACLE_T structured u8 1080p frames, mono, with use_pallas and
    use_pallas_vision, through the per-frame runner (K1, K3', K2' and K4
    once a frame) and the chunked runner (K1, K3, K2 and K4 once), both
    against one oracle run; each oracle in its child since start_oracles.
    The counts are set to 0 before each run and read after it (paths
    oracle_parity, oracle_frame, oracle_chunk), exactly the kernels named.
    Hues equal and every error under the JAX harness's gates, the errors
    beside the JAX package's documented results.  (c) audit_stages at
    1080x1920, each stage beside its tolerance and the TPU audit's figure
    (benchmarks/TPU_PARITY_r05.json, a TPU v5 lite's, not the port's).
    Fails on any gate or stage that is not ok, after printing them all."""
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.utils.parity import audit_stages, run_parity
    t_phase = time.perf_counter()
    flagship = AuralizerConfig(use_pallas=True, use_pallas_vision=True)
    k1234 = ("mip_pool_u8", "vision_stats", "hann_peak_weighted_sum",
             "agc_overlap_add")
    runs = (("oracle_parity", "parity", parity_input(), AuralizerConfig(),
             "frame", {"hann_peak_weighted_sum": PARITY_FRAMES}),
            ("oracle_frame", "frames", frames, flagship, "frame",
             {k: len(frames) for k in k1234}),
            ("oracle_chunk", "frames", frames, flagship, "chunked",
             {k: 1 for k in k1234}))
    counts, refs, failed = {}, {}, []
    for path, name, clip, cfg, runner, want in runs:
        if name not in refs:
            refs[name] = finish_oracle(jobs, name)
        ref, oracle_s, waited_s = refs[name]
        reset_counts()
        t0 = time.perf_counter()
        rep = run_parity(clip, cfg, "cuda", runner, reference=ref)
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t0
        counts[path] = got = read_counts()
        if got != {k: want.get(k, 0) for k in got}:
            failed.append(f"{path}: launches {got}, expected {want}")
        err, gates, bands = rep["max_abs_err"], rep["gates"], rep["bands"]
        if not rep["ok"]:
            failed.append(f"{path}: {rep}")
        say(f"oracle {path}: {len(clip)} {clip.dtype} frames "
            f"{clip.shape[1]}x{clip.shape[2]} through the {runner} runner "
            f"on the card against the f64 literal oracle: hues identical "
            f"{rep['hues_identical']}; grads {err['grads']:.3e} (gate "
            f"{gates['grads']:.0e}), spectrum {err['spectrum']:.3e} (gate "
            f"{gates['spectrum']:.0e}; the JAX package's documented "
            f"{bands['spectrum']:.1e}), pcm {err['pcm']:.3e} (gate "
            f"{gates['pcm']:.0e}; documented {bands['pcm']:.0e}) "
            f"{'PASS' if rep['ok'] else 'FAIL'}; launches "
            f"{ {k: v for k, v in got.items() if v} }; the port "
            f"{port_s:.3f} s; the oracle {oracle_s:.1f} s in its child on "
            f"the host's CPU, {waited_s:.1f} s waited for here ({smi})")
    jobs["stop"]()
    tpu = json.loads((Path(__file__).resolve().parent / TPU_AUDIT)
                     .read_text())
    t0 = time.perf_counter()
    audit = audit_stages("cuda", res="1080x1920")
    audit_s = time.perf_counter() - t0
    for stage, st in audit["stages"].items():
        got = (f"{st['max_abs_err']:.3e}" if "max_abs_err" in st
               else f"ERROR {st['error']}")
        ref_name = TPU_STAGE.get(stage, stage)
        theirs = (f"{tpu['stages'][ref_name]['max_abs_err']:.3e} "
                  f"({ref_name}, {TPU_AUDIT}: the TPU's, not the port's)"
                  if ref_name in tpu["stages"] else "no TPU counterpart")
        say(f"oracle audit {stage} on the card at 1080x1920: {got} (tol "
            f"{st['tol']:.3e}) {'PASS' if st['ok'] else 'FAIL'} | "
            f"{tpu['device']}: {theirs} ({smi})")
        if not st["ok"]:
            failed.append(f"audit {stage}: {st}")
    say(f"oracle: audit_stages {audit_s:.1f} s; the phase "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    if failed:
        fail("oracle: " + "; ".join(failed))
    return counts


# ---------------------------------------------------------------------------
# The headline benchmark, python -m vaudio_torch bench
# ---------------------------------------------------------------------------

BENCH_ENV = {"VAUDIO_BENCH_ITERS": "4", "VAUDIO_BENCH_MAX_REPS": "4"}
BENCH_T = 16                     # frames of the in-process counted call
# bench.py's record (bench.py:357-391) at its default settings, and the
# card's identity the port adds.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "us_per_frame",
              "static_floor_us", "pct_of_floor", "ingest_hbm_gbs", "stable",
              "valid_reps", "slopes_us", "scan_path_x_realtime",
              "scan_stable", "scan_block", "mono_x_realtime", "mono_stable",
              "device", "power_limit_w", "torch", "cuda", "nvcc")


def phase_bench(smi: str, res=(1080, 1920)) -> dict:
    """The port's headline benchmark, ``python -m vaudio_torch bench``, as
    a child process at ``res`` (VAUDIO_BENCH_RES) with the default chunks
    (16,128) and BENCH_ENV (4 calls a timed loop, at most 4 reps): its JSON
    line printed with the card's name and power limit, and its
    measurements' lines from stderr (slopes, each path's first-call
    launches, which the child itself requires of the kernels
    ``bench.expected_kernels`` names, peak device memory); fails if the
    child fails, its line is missing or lacks a key, ``value`` <= 0,
    ``fallback_upper_bound`` is set or ``static_floor_us`` is not
    ``bench.static_floor_us``'s at ``res``.  Then one call of the bench's
    chunked callable on BENCH_T device frames in process, the counts set
    to 0 before it and read after it (path ``bench``): K1, K2 and K4 once,
    nothing else; its PCM equal bit for bit to ``run_offline_batched`` on
    the same frames."""
    from vaudio_torch import bench
    from vaudio_torch.runtime.chunked import run_offline_batched
    from vaudio_torch.runtime.step import init_carry
    H, W = res
    t0 = time.perf_counter()
    out, err, _ = finish_cli(start_cli(
        ["bench"], env=dict(BENCH_ENV, VAUDIO_BENCH_RES=f"{H}x{W}")),
        f"bench {H}x{W}")
    wall = time.perf_counter() - t0
    for line in err.splitlines():
        if re.search(r"median|UPPER BOUND|launches|static floor|peak device",
                     line):
            say(line)
    lines = out.decode(errors="replace").strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"bench: no JSON line last on stdout:\n{err[-3000:]}")
    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing:
        fail(f"bench: the line lacks {missing}: {rec}")
    if not rec["value"] > 0 or rec.get("fallback_upper_bound"):
        fail(f"bench: no positive slope: {rec}")
    if rec["device"] != torch.cuda.get_device_name(0):
        fail(f"bench: the line names {rec['device']!r}")
    cfg = bench.bench_config(2)
    floor = round(sum(bench.static_floor_us(H, W, cfg)), 2)
    if rec["static_floor_us"] != floor:
        fail(f"bench {H}x{W}: static_floor_us {rec['static_floor_us']}, "
             f"expected {floor}")
    say(f"bench: python -m vaudio_torch bench at {H}x{W}, chunks 16,128, "
        f"{BENCH_ENV}: {wall:.1f} s with the process's start-up ({smi})")
    say(f"bench line ({smi}): {json.dumps(rec)}")

    run = bench.make_runner(cfg, "chunked", 8, torch.device("cuda"))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    frames = torch.randint(0, 256, (BENCH_T, H, W, 3),
                           dtype=torch.uint8, device="cuda", generator=g)
    run(init_carry(cfg, "cuda"), frames)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, outs = run(init_carry(cfg, "cuda"), frames)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    want = {"mip_pool_u8": 1, "hann_peak_weighted_sum": 1,
            "agc_overlap_add": 1}
    if counts != {k: want.get(k, 0) for k in counts}:
        fail(f"bench: one chunked call launched {counts}, expected {want}")
    pcm = outs["pcm"]
    if pcm.shape != (BENCH_T, cfg.hop_size, 2) or not bool(
            torch.isfinite(pcm).all()) or not bool((pcm != 0).any()):
        fail(f"bench: the chunked call's PCM {tuple(pcm.shape)} is not "
             f"finite and non-zero")
    ref, _, _ = run_offline_batched(frames, cfg, chunk=BENCH_T,
                                    device="cuda")
    if not bits_equal(pcm.reshape(-1, 2), ref):
        fail("bench: the chunked callable's PCM differs from "
             "run_offline_batched's on the same frames")
    say(f"bench: one call of the bench's chunked callable on {BENCH_T} "
        f"device frames {H}x{W} stereo: {call_ms:.3f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} }, PCM equal to "
        f"run_offline_batched's bit for bit ({smi})")
    return counts


# ---------------------------------------------------------------------------
# The 4K configuration, 2160x3840 (the JAX package's second published one)
# ---------------------------------------------------------------------------

UHD = (2160, 3840)               # 4K: mip 3 is 270x480, past K3's gate
UHD_T = 64                       # frames of the 4K offline and live runs
UHD_SERVE_T = 16                 # I420 frames of the served 4K run
UHD_CPU_T = 2                    # 4K frames held card vs CPU
UHD_PROFILE_T = 16               # frames of each profiled 4K live run
# The structured 4K clips in child processes, from before the kernel phases
# (numpy on one host core each, ~15 s for the RGB frames and ~40 s for the
# YUV ones): ``python -c UHD_CHILD <tests dir> rgb|yuv <T> <H> <W> <out>``
# writes tests/torch_frames.py's structured_frames (seed 4) or
# structured_yuv_frames (seed 5) to <out> (.npy, .npz).
UHD_CHILD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from torch_frames import structured_frames, structured_yuv_frames
kind, (T, H, W), out = sys.argv[2], map(int, sys.argv[3:6]), sys.argv[6]
if kind == "rgb":
    np.save(out, structured_frames(4, T, H, W))
else:
    np.savez(out, **structured_yuv_frames(5, T, H, W))
"""


def start_uhd_frames() -> dict:
    """Start the two UHD_CHILD processes (REALTIME_T RGB frames, UHD_T YUV
    frames); :func:`finish_uhd_frames` reads their files.  At exit the work
    directory is removed (spawn() kills a child still running)."""
    import shutil
    work = Path(tempfile.mkdtemp(prefix="vaudio_4k_"))
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    tests = str(Path(__file__).resolve().parent / "tests")
    procs = {kind: spawn([sys.executable, "-c", UHD_CHILD, tests, kind,
                          *map(str, (n, *UHD)), str(work / f"{kind}.{ext}")],
                         env=repo_env(), stdout=subprocess.DEVNULL,
                         stderr=subprocess.PIPE)
             for kind, n, ext in (("rgb", REALTIME_T, "npy"),
                                  ("yuv", UHD_T, "npz"))}
    return {"procs": procs, "work": work, "t0": time.perf_counter()}


def finish_uhd_frames(jobs: dict, smi: str):
    """(RGB frames u8[REALTIME_T, *UHD, 3], I420 planes dict of UHD_T
    frames), failing the run unless both children exit 0."""
    for kind, proc in jobs["procs"].items():
        limit = max(30.0, _deadline - time.monotonic() - 30)
        try:
            _, err = proc.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            fail(f"4K {kind} frames: still being made after {limit:.0f} s")
        if proc.returncode != 0:
            fail(f"4K {kind} frames: exit {proc.returncode}:\n"
                 f"{err.decode(errors='replace')[-3000:]}")
    frames = np.load(jobs["work"] / "rgb.npy")
    with np.load(jobs["work"] / "yuv.npz") as z:
        yuv = {k: z[k] for k in "yuv"}
    say(f"frames: {len(frames)} structured u8 RGB and {len(yuv['y'])} I420 "
        f"frames {UHD[0]}x{UHD[1]} made by two child processes, ready "
        f"{time.perf_counter() - jobs['t0']:.1f} s after their start "
        f"({smi})")
    return frames, yuv


def res_of(clip) -> str:
    """A clip's frame size, HxW."""
    h, w = (clip["y"] if isinstance(clip, dict) else clip).shape[1:3]
    return f"{h}x{w}"


def plan_of(entry_name: str, T: int, H: int, W: int, level: int) -> str:
    """The launch K1's entry takes (ops.pool_kernel.launch_plan), as text."""
    from vaudio_torch.ops import pool_kernel as pk
    p = pk.launch_plan(entry_name, T, H, W, level)
    return (f"{p['tiles']} column tile{'s' if p['tiles'] > 1 else ''} of "
            f"{p['tile']} texels a row, grid {p['tiles']}x{H >> level}x{T}, "
            f"{p['threads']} threads and {p['smem']} B of shared memory a "
            f"block")


def phase_k1_4k(smi: str) -> list:
    """K1's three entries at 2160x3840, mip 3, against their plain versions
    bit for bit (the integer sums exact too): the interleaved RGB entry at
    T = 1, 8 and 64 (the 4K live per-frame step, the live chunks of 8, the
    offline chunk), the YUV entry at T = 64 and 1 (the offline I420 chunk,
    the served I420 per-frame step: Y at mip 3, U, V [T, 1080, 1920] at mip
    2) and the planar entry on the Y planes at T = 64 and 1 (on no main
    path, as at 1080p); each with its launch's column tiles, both times, the
    bound and its share."""
    from vaudio_torch.ops import pool_kernel as pk
    H, W = UHD
    gen = torch.Generator(device="cuda").manual_seed(4)

    def planes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    entries = []
    every = planes(UHD_T, H, W, 3)
    out_n = (H >> MIP) * (W >> MIP)          # texels of one mip plane
    for T, path in ((1, "4k_live_frame"), (LIVE_CHUNK, "4k_live_chunk"),
                    (UHD_T, "4k_offline")):
        frames = every[:T]
        chans = frames.permute(0, 3, 1, 2)
        k = float(4 ** MIP)
        if not torch.equal(pk.mip_pool(frames, MIP, scale=k),
                           pk.mip_pool_plain(chans, MIP, scale=k)):
            fail(f"K1 4K T={T}: integer block sums differ from the plain "
                 f"version")
        got = pk.mip_pool(frames, MIP, scale=1.0 / 255.0)
        ref = pk.mip_pool_plain(chans, MIP, scale=1.0 / 255.0)
        if got.shape != (T, 3, H >> MIP, W >> MIP) or not bits_equal(got,
                                                                    ref):
            fail(f"K1 4K T={T}: differs from the plain version (shape "
                 f"{tuple(got.shape)})")
        del got, ref
        e = entry(f"mip_pool_u8_4k_t{T}", "vaudio_torch/csrc/pool_kernel.cu",
                  "vaudio/ops/pool_kernel.py:130", 0.0,
                  lambda: pk.mip_pool(frames, MIP, scale=1.0 / 255.0),
                  lambda: pk.mip_pool_plain(chans, MIP, 1.0 / 255.0),
                  nbytes=T * H * W * 3 + 4 * 3 * T * out_n,
                  ops=T * H * W * 3 + K1_EPILOGUE_OPS * 3 * T * out_n,
                  path=path, counter="mip_pool_u8")
        say(f"K1 4K mip_pool u8 [{T},{H},{W},3] mip {MIP}: sums exact, equal "
            f"to the plain version bit for bit; "
            f"{plan_of('rgb', T, H, W, MIP)}; {timing(e)}; {share(e)} "
            f"({smi})")
        entries.append(e)
    del every
    y, u, v = planes(UHD_T, H, W), planes(UHD_T, H // 2, W // 2), \
        planes(UHD_T, H // 2, W // 2)
    for T, path in ((UHD_T, "4k_offline_yuv"), (1, "4k_serve_yuv")):
        yn, un, vn = y[:T], u[:T], v[:T]
        err = max(k1_planar_check(f"K1 4K planar Y T={T}", yn, MIP, Y_SCALE),
                  k1_planar_check(f"K1 4K planar U T={T}", un, MIP - 1,
                                  C_SCALE),
                  k1_planar_check(f"K1 4K planar V T={T}", vn, MIP - 1,
                                  C_SCALE))
        k1_yuv_check(f"K1 4K YUV T={T}", yn, un, vn, MIP)
        planar = entry(
            f"mip_pool_planes_u8_4k_t{T}", "vaudio_torch/csrc/pool_kernel.cu",
            "vaudio/ops/pool_kernel.py:130", err,
            lambda: pk.mip_pool_planes(yn, MIP, Y_SCALE),
            lambda: pk.mip_pool_plain(yn, MIP, Y_SCALE),
            nbytes=T * H * W + 4 * T * out_n,
            ops=T * H * W + K1_EPILOGUE_OPS * T * out_n, path=path,
            counter="mip_pool_planes_u8")
        say(f"K1 4K mip_pool_planes u8 Y [{T},{H},{W}] mip {MIP}: sums exact, "
            f"U and V [{T},{H // 2},{W // 2}] at mip {MIP - 1} too, equal bit "
            f"for bit; {plan_of('planes', T, H, W, MIP)}; {timing(planar)}; "
            f"{share(planar)} (on no main path) ({smi})")
        fused = entry(
            f"mip_pool_yuv420_u8_4k_t{T}", "vaudio_torch/csrc/pool_kernel.cu",
            "vaudio/ops/pool_kernel.py:130", 0.0,
            lambda: pk.mip_pool_yuv420(yn, un, vn, MIP),
            lambda: pk.mip_pool_yuv420_plain(yn, un, vn, MIP),
            nbytes=T * H * W * 3 // 2 + 4 * 3 * T * out_n,
            ops=T * H * W * 3 // 2 + K1_YUV_TEXEL_OPS * T * out_n, path=path,
            counter="mip_pool_yuv420_u8")
        say(f"K1 4K mip_pool_yuv420 u8 one I420 dispatch T={T}: Y "
            f"[{T},{H},{W}] mip {MIP} + U,V [{T},{H // 2},{W // 2}] mip "
            f"{MIP - 1} in 1 launch to the clamped RGB mips "
            f"[{T},3,{H >> MIP},{W >> MIP}]: equal to the plain version bit "
            f"for bit; {plan_of('yuv420', T, H, W, MIP)}; {timing(fused)}; "
            f"{share(fused)} ({smi})")
        entries.append(fused)
    del y, u, v
    torch.cuda.empty_cache()
    return entries


def unfused_vision(mips, cfg):
    """The vision stages after the mip pool where K3's gate refuses the mip
    (vision.features.frame_stats): HSI with the polynomial acos when
    ``fast_hue_acos``, the histogram's scatter-add, the stencils, the
    cells' statistics."""
    from vaudio_torch.vision import features as vf
    h, s, i = vf.rgb_to_hsi_planes(mips[:, 0], mips[:, 1], mips[:, 2],
                                   fast_acos=cfg.fast_hue_acos)
    return (vf.hue_histogram_planes(h, s, i, cfg),
            vf.cell_gradient_stats_planes(vf.feature_stencil_plane(i), cfg))


def phase_k3_4k(frames: np.ndarray, smi: str) -> None:
    """K3 called directly on the 270x480 mips of structured 4K frames at
    T = 8 and 1, where both packages' gate (``supports``) keeps it off the
    paths: counts equal to the plain version's, statistics within atol
    1e-6, rtol 1e-5 (tests/test_torch_cuda.py's band); its times beside the
    bound, and the unfused stages' device time a frame beside it (what
    the 4K paths run)."""
    from vaudio_torch.ops import pool_kernel
    from vaudio_torch.ops import vision_kernel as vk
    cfg = live_config()
    mips = pool_kernel.mip_pool(torch.as_tensor(frames[:LIVE_CHUNK],
                                                device="cuda"),
                                MIP, scale=1.0 / 255.0)
    hm, wm = mips.shape[-2:]
    if vk.supports(hm, wm, cfg) or not vk.kernel_takes(hm, wm, cfg):
        fail(f"K3 at {hm}x{wm}: the gate takes it, or the kernel does not")
    for T in (LIVE_CHUNK, 1):
        m = mips[:T].contiguous()
        hist, grads = vk.vision_stats(m, cfg)
        ref_h, ref_g = vk.vision_stats_plain(m, cfg)
        if not torch.equal(hist, ref_h) or float(hist.sum()) <= 0:
            fail(f"K3 4K T={T}: the histogram differs from the plain "
                 f"version's (L1 {float((hist - ref_h).abs().sum())}) or is "
                 f"empty")
        if not torch.allclose(grads, ref_g, rtol=1e-5, atol=1e-6):
            fail(f"K3 4K T={T}: statistics differ from the plain version by "
                 f"{float((grads - ref_g).abs().max()):.3e}")
        err = float((grads - ref_g).abs().max())
        e = entry(f"vision_stats_4k_t{T}",
                  "vaudio_torch/csrc/vision_kernel.cu",
                  "vaudio/ops/vision_kernel.py:"
                  + ("313" if T == 1 else "352"), err,
                  lambda: vk.vision_stats(m, cfg),
                  lambda: vk.vision_stats_plain(m, cfg),
                  nbytes=4 * T * (3 * hm * wm + 16 * (360 + 4)),
                  ops=T * hm * wm * K3_PIXEL_OPS, path="4k_offline",
                  counter="vision_stats")
        unfused_dev = device_ms(lambda: unfused_vision(m, cfg))
        unfused_ev = cuda_ms(lambda: unfused_vision(m, cfg))
        say(f"K3 4K vision_stats T={T} mip {hm}x{wm}, called directly (off "
            f"every 4K path: supports() refuses the mip in both packages): "
            f"counts equal, statistics max_abs_err {err:.3e}; {timing(e)}; "
            f"{share(e)}; the unfused stages the 4K paths run instead: "
            f"{unfused_ev / T:.4f} ms a frame ({unfused_dev / T:.4f} on the "
            f"device), K3 {e['ms'] / T:.4f} ({e['device_ms'] / T:.4f}) a "
            f"frame ({smi})")


def uhd_launch_check(what: str, launches: dict, pool: str, n_pool: int,
                     n_k4: int) -> None:
    """Fail unless a 4K run launched ``pool`` n_pool times, K2 at least
    once, K4 n_k4 times, and K3 and the other K1 entries never."""
    other = [k for k in ("mip_pool_u8", "mip_pool_planes_u8",
                         "mip_pool_yuv420_u8") if k != pool]
    if (launches[pool] != n_pool or launches["hann_peak_weighted_sum"] < 1
            or launches["agc_overlap_add"] != n_k4
            or launches["vision_stats"] or any(launches[k] for k in other)):
        fail(f"{what}: launches {launches}; expected {pool} {n_pool}, K2, "
             f"K4 {n_k4}, and no K3 (the gate) nor another K1 entry")


def phase_offline_4k(frames: np.ndarray, yuv: dict, smi: str) -> dict:
    """``Auralizer.sonify`` at 4K, chunk 64, stereo 48 kHz with
    ``use_pallas_vision`` (K3 gated off, as in the JAX package): RGB from
    host frames and from device frames (PCM equal bit for bit) and I420;
    K1 (its entry), K2 and K4 once a chunk, K3 never; ms a frame and peak
    device memory; the first UHD_CPU_T frames through the chunked path on
    the card and on the CPU (hues equal, PCM within 1e-4).  Returns the
    counts by path."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.runtime.chunked import run_offline_batched
    cfg = dataclasses.replace(offline_config(), use_pallas_vision=True)
    aur = Auralizer(config=cfg, device="cuda")
    counts = {}
    for clip, path in ((frames[:UHD_T], "4k_offline"),
                       (yuv, "4k_offline_yuv")):
        is_yuv = isinstance(clip, dict)
        what = "I420 " if is_yuv else "RGB "
        aur.sonify(clip)                                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        audio = aur.sonify(clip)
        wall = time.perf_counter() - t0
        counts[path] = launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if audio.shape != (UHD_T * cfg.hop_size, 2) or not np.all(
                np.isfinite(audio)) or not np.any(audio != 0):
            fail(f"4K offline {what}: PCM {audio.shape} not finite or silent")
        uhd_launch_check(f"4K offline {what}", launches, pool_of(clip), 1, 1)
        line = (f"offline 4K: Auralizer.sonify {UHD_T} {what}frames "
                f"{res_of(clip)} stereo 48 kHz chunk {CHUNK_T}, "
                f"use_pallas_vision: {1e3 * wall / UHD_T:.3f} ms/frame from "
                f"host frames, peak device memory {peak:.2f} GiB")
        if not is_yuv:
            dev = torch.as_tensor(clip, device="cuda")
            aur.sonify(dev)                              # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            again = aur.sonify(dev)
            wall_dev = time.perf_counter() - t0
            peak_dev = torch.cuda.max_memory_allocated() / 2**30
            uhd_launch_check("4K offline from device frames", read_counts(),
                             "mip_pool_u8", 1, 1)
            if not np.array_equal(again, audio):
                fail("4K offline: device frames' PCM differs from host "
                     "frames'")
            line += (f"; {1e3 * wall_dev / UHD_T:.3f} ms/frame from device "
                     f"frames, peak {peak_dev:.2f} GiB, PCM equal bit for "
                     f"bit")
            del dev
        part = clip_slice(clip, 0, UHD_CPU_T)
        a_gpu, _, d_gpu = run_offline_batched(part, cfg, debug=True,
                                              device="cuda")
        a_cpu, _, d_cpu = run_offline_batched(part, cfg, debug=True,
                                              device="cpu")
        err = float((a_gpu.cpu() - a_cpu).abs().max())
        if not torch.equal(d_gpu["hues"].cpu(), d_cpu["hues"]) or \
                not err <= 1e-4 or not bool((a_cpu != 0).any()):
            fail(f"4K offline {what}: card vs CPU on {UHD_CPU_T} frames: hues "
                 f"equal {torch.equal(d_gpu['hues'].cpu(), d_cpu['hues'])}, "
                 f"PCM max diff {err:.3e}")
        say(f"{line}; launches { {k: v for k, v in launches.items() if v} } "
            f"(K3 0: the gate); {UHD_CPU_T} frames card vs CPU: hues equal, "
            f"PCM max diff {err:.3e} ({smi})")
    return counts


def phase_live_4k(frames: np.ndarray, smi: str) -> dict:
    """The live stream at 4K (``live_config()``: use_pallas and
    use_pallas_vision, K3 gated off), UHD_T frames per frame and in chunks
    of 8: K1, K2 and K4 once a dispatch, K3 never, nothing dropped, the
    pulled PCM equal bit for bit to the offline runs on the card with the
    stream's dispatches; UHD_PROFILE_T frames of each under the profiler
    (host-to-device copies a dispatch, the device's idle share); then
    REALTIME_T frames paced at 30 fps, none dropped.  Returns the counts by
    path."""
    from vaudio_torch.api import Auralizer
    cfg = live_config()
    clip = frames[:UHD_T]
    for chunk in (1, LIVE_CHUNK):                   # warm-up
        Auralizer(source=frames[:LIVE_CHUNK], config=cfg, device="cuda",
                  chunk_frames=chunk).run_until_exhausted(timeout=300)
    torch.cuda.synchronize()
    counts = {}
    for chunk, path in ((1, "4k_live_frame"), (LIVE_CHUNK, "4k_live_chunk")):
        aur = Auralizer(source=clip, config=cfg, device="cuda",
                        chunk_frames=chunk)
        reset_counts()
        t0 = time.perf_counter()
        aur.run_until_exhausted(timeout=300)
        wall = time.perf_counter() - t0
        counts[path] = launches = read_counts()
        m = aur.metrics
        got = aur.pull(UHD_T * cfg.hop_size * cfg.channels)
        uhd_launch_check(f"4K live chunk_frames={chunk}", launches,
                         "mip_pool_u8", UHD_T // chunk, UHD_T // chunk)
        if m["frames_processed"] != UHD_T or m["dropped_frames"]:
            fail(f"4K live chunk_frames={chunk}: {m}")
        ref = offline_by_pattern(clip, [chunk] * (UHD_T // chunk), cfg)
        if not np.array_equal(got, ref) or not np.any(got != 0):
            fail(f"4K live chunk_frames={chunk}: the pulled PCM differs from "
                 f"the offline run on the card (or is silent)")
        say(f"live 4K: Auralizer(...).run_until_exhausted {UHD_T} frames "
            f"{res_of(clip)} stereo 48 kHz chunk_frames={chunk}: "
            f"{1e3 * wall / UHD_T:.3f} ms/frame, latency p50 "
            f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms "
            f"(unpaced); PCM equal to the offline run on the card; launches "
            f"{ {k: v for k, v in launches.items() if v} } in "
            f"{m['dispatches']} dispatches (K3 0: the gate) ({smi})")
        source = frames[:UHD_PROFILE_T]
        aur = Auralizer(source=source, config=cfg, device="cuda",
                        chunk_frames=chunk)
        rows, wall_ms = profiled(lambda: aur.run_until_exhausted(
            timeout=300))
        say(profile_line(f"live 4K chunk_frames={chunk}", rows, wall_ms,
                         UHD_PROFILE_T, aur.metrics["dispatches"], smi,
                         shape=f"{res_of(source)} stereo"))
    phase_realtime(frames, smi)
    return counts


def phase_serve_4k(yuv: dict, smi: str) -> dict:
    """UHD_SERVE_T I420 4K frames as raw bodies (12.4 MB each) through
    ``POST /frames`` of a served stream at ``live_config()``, per frame:
    K1's YUV entry, K2 and K4 once a dispatch, K3 never; nothing dropped;
    the pulled PCM equal bit for bit to the offline run on the card with
    the stream's dispatches.  Returns the counts by path."""
    from vaudio_torch.api import Auralizer
    from vaudio_torch.io import PushSource
    cfg = live_config()
    clip = clip_slice(yuv, 0, UHD_SERVE_T)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "dispatches.jsonl")
        ps = PushSource(maxsize=UHD_SERVE_T, when_empty="block")
        aur = Auralizer(source=ps, config=cfg, device="cuda", metrics_log=log)
        srv = aur.serve(port=0)
        try:
            reset_counts()
            t0 = time.perf_counter()
            aur.start()
            push_clip(srv.url, clip)
            wait_stream_end(aur, 300, "serve 4K")
            wall = time.perf_counter() - t0
            launches = read_counts()
            m = aur.metrics
            got = aur.pull(UHD_SERVE_T * cfg.hop_size * cfg.channels)
        finally:
            srv.stop()
            aur.stop()
        pattern = [json.loads(line)["frames"] for line in open(log)]
    if (m["frames_processed"] != UHD_SERVE_T or m["dropped_frames"]
            or ps.dropped or ps.pushed != UHD_SERVE_T):
        fail(f"serve 4K: {m}, queue {ps.state()}")
    uhd_launch_check("serve 4K", launches, "mip_pool_yuv420_u8",
                     len(pattern), len(pattern))
    ref = offline_by_pattern(clip, pattern, cfg)
    if not np.array_equal(got, ref) or not np.any(got != 0):
        fail("serve 4K: the pulled PCM differs from the offline run on the "
             "card (or is silent)")
    body = sum(clip[k][0].nbytes for k in "yuv")
    say(f"serve 4K: {UHD_SERVE_T} raw I420 frames {res_of(clip)} "
        f"({body / 1e6:.1f} MB bodies) stereo 48 kHz through "
        f"POST /frames, per frame: {1e3 * wall / UHD_SERVE_T:.3f} ms/frame "
        f"from the first push to the stream's end; latency p50 "
        f"{m['latency_p50_ms']:.3f} ms p99 {m['latency_p99_ms']:.3f} ms; "
        f"nothing dropped; PCM equal to the offline run on the card with the "
        f"stream's {len(pattern)} dispatches; launches "
        f"{ {k: v for k, v in launches.items() if v} } (K3 0: the gate) "
        f"({smi})")
    return {"4k_serve_yuv": launches}


def phase_4k(jobs: dict, smi: str):
    """The 4K configuration (2160x3840, mip 3 = 270x480) through the
    port's main path: K1's entries and K3 called directly, then the
    offline, live, paced, served and bench paths, each with its launches
    (K3 never: its gate refuses the 4K mip, as in the JAX package).
    Returns (the kernels' entries, the counts by path)."""
    t0 = time.perf_counter()
    frames, yuv = finish_uhd_frames(jobs, smi)
    kernels = phase_k1_4k(smi)
    phase_k3_4k(frames, smi)
    counts = phase_offline_4k(frames, yuv, smi)
    counts.update(phase_live_4k(frames, smi))
    counts.update(phase_serve_4k(yuv, smi))
    counts["4k_bench"] = phase_bench(smi, UHD)
    say(f"4K: the phase took {time.perf_counter() - t0:.1f} s ({smi})")
    return kernels, counts


def main() -> None:
    global _deadline
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs "
             "only on a GPU")
    _deadline = time.monotonic() + RUN_LIMIT_S
    arm_watchdog()
    import vaudio_torch  # noqa: F401  (fails outside the repository)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_frames import structured_frames, structured_yuv_frames
    smi = phase_env()
    phase_build(smi)
    phase_native(smi)
    t0 = time.perf_counter()
    frames = structured_frames(0, REALTIME_T, 1080, 1920)
    say(f"frames: {REALTIME_T} structured u8 frames 1080x1920 made in "
        f"{time.perf_counter() - t0:.1f} s on the host ({smi})")
    t0 = time.perf_counter()
    yuv = structured_yuv_frames(0, LIVE_T, 1080, 1920)
    say(f"frames: {LIVE_T} structured YUV 4:2:0 frames 1080x1920 (I420, "
        f"BT.601 studio swing) made in {time.perf_counter() - t0:.1f} s on "
        f"the host ({smi})")
    uhd_jobs = start_uhd_frames()
    kernels = [*phase_k1(smi), *phase_k1_planar(smi), *phase_k2(smi)]
    counts, ms = {}, {}
    counts["offline"], ms["offline"] = phase_offline(frames[:CHUNK_T], smi)
    counts["offline_yuv"], ms["offline_yuv"] = phase_offline(yuv, smi)
    kernels += [*phase_k3(frames, smi), *phase_k4(smi),
                *phase_k4_streams(smi)]
    for clip in (frames, yuv):
        c, w = phase_live(clip, smi)
        counts.update(c)
        ms.update(w)
    say("YUV 4:2:0 against RGB, ms/frame in this call: "
        + ", ".join(f"{p} {ms[p.replace('_yuv', '')]:.3f} -> {ms[p]:.3f}"
                    for p in ms if "_yuv" in p) + f" ({smi})")
    phase_profile(frames, smi)
    phase_profile(yuv, smi)
    counts.update(phase_serve(frames, yuv, ms, smi))
    phase_native_reader(frames, yuv, smi)
    phase_flags(frames[:CHUNK_T], smi)
    phase_debug(frames[:CHUNK_T], smi)
    phase_realtime(frames, smi)
    phase_paced(frames, smi)
    counts["ortho_offline"] = phase_ortho_offline(frames[:CHUNK_T], smi)
    counts.update(phase_ortho_live(frames, smi))
    counts.update(phase_ortho_serve(frames, smi))
    phase_ortho_resolution(frames, smi)
    counts.update(phase_pod(frames, yuv, smi))
    counts.update(phase_pod_serve(frames, yuv, smi))
    mesh_counts, mesh_kernels = phase_mesh(frames, smi)
    counts.update(mesh_counts)
    kernels += mesh_kernels
    oracles = start_oracles({"parity": parity_input(),
                             "frames": frames[:ORACLE_T]})
    counts.update(phase_hostpod(frames, smi))
    counts.update(phase_cli(frames, smi))
    phase_entry(frames, smi)
    counts.update(phase_oracle(frames[:ORACLE_T], oracles, smi))
    counts["bench"] = phase_bench(smi)
    uhd_kernels, uhd_counts = phase_4k(uhd_jobs, smi)
    kernels += uhd_kernels
    counts.update(uhd_counts)
    for k in kernels:
        base = k.pop("counter")
        k["launches"] = counts[k["path"]][base]
        k["launches_by_path"] = {p: c[base] for p, c in counts.items()}
    say(smi)
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
