"""Serving-pod walkthrough: run N clients through one batched step a tick,
watch them on the live panel, control a slot, churn a client, and
checkpoint the whole pod over HTTP (a copy of ``examples/serving_pod.py``).

    python -m vaudio_torch.examples.serving_pod [--hold]
    VAUDIO_PLATFORM=cpu python -m vaudio_torch.examples.serving_pod

(``--hold`` keeps the panel up for a browser until Ctrl-C.)  The pod is a
:class:`~vaudio_torch.runtime.multistream.MultiStreamAuralizer` behind its
:class:`~vaudio_torch.runtime.podserver.PodServer`, driven through the HTTP
clients of :mod:`vaudio_torch.client`.
"""

import sys
import time

import numpy as np


def main(hold=False, device=None):
    from vaudio_torch.client import PodClient
    from vaudio_torch.config import AuralizerConfig
    from vaudio_torch.io import hsb_frames
    from vaudio_torch.runtime import MultiStreamAuralizer
    from vaudio_torch.runtime.engine import AuralizerEngine

    # A pod serves one static shape; mip_level 1 keeps the 64x64 demo
    # frames past the count>20 hue gate (VisionEngine.swift:263).
    cfg = AuralizerConfig(mip_level=1)
    n = 4
    pod = MultiStreamAuralizer(cfg, n_streams=n, chunk_frames=2,
                               exit_when_exhausted=False,
                               max_streams=n + 2,
                               engine=AuralizerEngine(cfg, device=device))

    # --- live panel + ops endpoints -----------------------------------
    server = pod.serve(port=0)
    print(f"[panel] {server.url}  (slots, sliders, per-slot audio)")
    # Everything below drives the pod THROUGH that HTTP surface with the
    # programmatic client — what a remote operator or a fleet client
    # would run (vaudio_torch.client is numpy+urllib only).
    client = PodClient(server.url)

    def source(hue, frames=90):
        return iter(hsb_frames(hue, 1.0, 1.0, width=64, height=64,
                               num_frames=frames))

    pod.start([source(h) for h in (0.0, 0.25, 0.55, 0.8)])

    def wait_frames(k, timeout=120):
        t0 = time.monotonic()
        while pod.metrics.frames_processed < k:
            pod.raise_if_failed()
            if time.monotonic() - t0 > timeout:
                raise TimeoutError
            time.sleep(0.01)

    wait_frames(n * 20)

    # --- per-slot control --------------------------------------------
    resp = client.slot(2).set_params(attack=0.2, stereo_width=0.5)
    print(f"[control] slot 2: {resp['applied']} params applied mid-run")

    # --- pull audio like a per-client callback ------------------------
    pcm = pod.pull(1, 4096)
    print(f"[audio] slot 1 pulled 4096 samples, "
          f"rms={np.sqrt((pcm ** 2).mean()):.3f}")

    # --- client churn: re-arm a slot live ------------------------------
    pod.replace_source(0, source(0.6, frames=60), reset_carry=True)
    print("[churn] slot 0 re-armed with a new client (carry reset)")

    # --- elastic capacity: grow the live pod over HTTP -----------------
    grown = client.resize(n + 1)
    print(f"[resize] pod grown to {grown} slots mid-run "
          "(surviving slots' carries ride along)")
    pod.replace_source(n, source(0.4, frames=60))
    print(f"[resize] new slot {n} armed with a fresh client")

    # --- fleet allocation: a remote client leases a slot ---------------
    with client.lease(when_empty="dark") as leased:
        for fr in hsb_frames(0.15, 1.0, 1.0, width=64, height=64,
                             num_frames=8):
            leased.push(fr)
        print(f"[lease] leased slot {leased.index}, pushed 8 frames "
              f"(pod now {client.n_streams} slots); releasing")

    # --- ops: Prometheus scrape + HTTP checkpoint ----------------------
    prom = client.metrics_prom()
    print("[prom]", next(line for line in prom.splitlines()
                         if line.startswith("vaudio_frames_processed")))
    state = client.save_state()
    print(f"[ckpt] downloaded pod checkpoint: {len(state)} bytes "
          f"({pod.n_streams} slots x 5 arrays)")

    wait_frames(n * 40)
    m = pod.metrics_dict()
    print(f"[metrics] {m['frames_processed']} frames in "
          f"{m['dispatches']} dispatches, "
          f"p50 dispatch latency {m['dispatch_latency_p50_ms']:.1f} ms")

    if hold:
        print("[hold] panel live — Ctrl-C to exit")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    server.stop()
    pod.stop()
    print("[done]")
    return m


if __name__ == "__main__":
    from vaudio_torch.cli import platform_device
    main(hold="--hold" in sys.argv[1:], device=platform_device())
