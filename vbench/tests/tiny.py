"""Cells of the manifest at a size the CPU runs in seconds."""

import time

from vbench import manifest as mf
from vbench.drive import Cell

#: Traffic parameters scaled down for the CPU, by traffic mix (clips still
#: span two of the API's offline chunks).
TINY = {"offline-clips": dict(pool_frames=110, clip_frames=[70, 100],
                              clip_lengths=2, judge=2),
        "live-30fps": dict(pool_frames=12, warmup_frames=4),
        "pod-closed-8": dict(streams=2, pool_frames=12, warmup_frames=3,
                             judge=2)}


def tiny_cell(name: str, seconds: float = 1.5, seed: int = 2 ** 31 + 5,
              root=mf.ROOT):
    """(cell, entry, manifest) of workload ``name`` at 160x320 on the
    CPU."""
    manifest = mf.load(root)
    entry = mf.workload(manifest, name)
    config = mf.config(manifest, entry["config"], root)
    config["frame"].update(height=160, width=320)
    traffic = mf.traffic(entry["traffic"], root)
    traffic.update(TINY[entry["traffic"]])
    return (Cell(name, config, traffic, seed, seconds, False, "cpu",
                 time.time()), entry, manifest)
