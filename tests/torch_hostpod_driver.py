"""One process of a multi-process MultiHostPod run of the PyTorch port (not
a test module: tests/test_torch_hostpod.py and chip_smoke.py start it as
two real OS processes joined through torch.distributed on Gloo, as
tests/hostpod_driver.py does for the JAX package).  It imports neither jax
nor the JAX package.

Usage:

    python torch_hostpod_driver.py <process_id> <num_processes> <port>
        <clips.npy> <outdir> [--device cpu|cuda:0] [--chunk N]
        [--config JSON] [--timeout SECONDS]

The clips file holds the global pod's frames, (S, T, H, W, 3): slot g is
fed clips[g].  Each process joins ``tcp://127.0.0.1:<port>`` (every
collective fails after ``--timeout`` seconds instead of hanging), serves
its share of the S-slot pod on one local device (after a warm-up pod of
one tick), and writes each of its
slots' pulled PCM to ``<outdir>/pcm_<global slot>.npy`` and its tick
count, kernel launches (0 on the CPU, where the plain versions run) and ms
a tick to ``<outdir>/proc_<process_id>.json``.
"""

import argparse
import json
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("clips")
    ap.add_argument("outdir")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--config", default="{}",
                    help="AuralizerConfig fields as a JSON object")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()

    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.ops import (audio_kernel, pool_kernel,
                                  spectrum_kernel, vision_kernel)
    from vaudio_torch.parallel import (MultiHostPod, init_distributed,
                                       make_multihost_mesh)
    from vaudio_torch.runtime.engine import AuralizerEngine

    n = init_distributed(f"127.0.0.1:{args.port}", args.num_processes,
                         args.process_id, timeout=args.timeout)
    assert n == args.num_processes
    clips = np.load(args.clips, mmap_mode="r")
    n_global, n_frames = clips.shape[:2]
    cfg = AuralizerConfig(**json.loads(args.config))

    def serve(n):
        """One lockstep pod over the first ``n`` frames of every slot."""
        pod = MultiHostPod(cfg, n_global, frame=np.zeros_like(clips[0, 0]),
                           mesh=make_multihost_mesh(devices=[args.device]),
                           chunk_frames=args.chunk,
                           engine=AuralizerEngine(cfg, device=args.device))
        lo, hi = pod.local_slice.start, pod.local_slice.stop
        assert pod.metrics_dict()["global_streams"] == n_global
        pod.start([iter(np.array(clips[g, :n])) for g in range(lo, hi)])
        t0 = time.monotonic()
        while pod.is_running:
            pod.raise_if_failed()
            if time.monotonic() - t0 > args.timeout:
                raise TimeoutError("pod still running")
            time.sleep(0.001)
        pod.raise_if_failed()
        return pod, lo, hi, time.monotonic() - t0

    # A warm-up pod (the first tick loads the kernels and plans the FFTs),
    # then the measured one with the launch counts from 0.
    serve(args.chunk)[0].stop()
    for mod in (audio_kernel, pool_kernel, spectrum_kernel, vision_kernel):
        mod.launches = 0
    pod, lo, hi, wall = serve(n_frames)
    hop = cfg.hop_size * cfg.channels
    for i, g in enumerate(range(lo, hi)):
        np.save(f"{args.outdir}/pcm_{g}.npy", pod.pull(i, n_frames * hop))
    ticks = pod.metrics.dispatches
    launches = {"mip_pool_u8": pool_kernel.launches,
                "hann_peak_weighted_sum": spectrum_kernel.launches,
                "vision_stats": vision_kernel.launches,
                "agc_overlap_add": audio_kernel.launches}
    with open(f"{args.outdir}/proc_{args.process_id}.json", "w") as f:
        json.dump({"slots": [lo, hi], "ticks": ticks, "launches": launches,
                   "ms_per_tick": 1e3 * wall / max(ticks, 1)}, f)
    pod.stop()
    torch.distributed.destroy_process_group()
    print(f"proc {args.process_id}: slots {lo}:{hi} done, {ticks} ticks",
          flush=True)


if __name__ == "__main__":
    main()
