"""The comparison that decides ``correct``: the PCM the timed path
produced, against the plain reference run over the same frames from each
stream's first frame.

The number compared is ``pcm_gap``: the widest absolute gap between a
sample of the program's PCM (both channels) and the reference's.  The
sample is drawn from the seed: the longest item and ``judge - 1`` others
(every item where there are no more).  Each cell's limit is in
``vbench/limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np

from vbench.drive import Cell, Judged
from vbench.frames import FramePool


def reference_class(config: Dict):
    """The plain reference a configuration file names."""
    name = config["reference"]
    module = importlib.import_module(f"vbench.reference.{name}")
    return module.REFERENCE


def sample(cell: Cell, judged: List[Judged]) -> List[Judged]:
    """The longest item and others drawn from the seed, ``judge`` in all."""
    k = int(cell.traffic["judge"])
    items = [j for j in judged if len(j.pool_index)]
    if len(items) <= k:
        return items
    longest = max(range(len(items)), key=lambda i: len(items[i].pool_index))
    rest = [i for i in range(len(items)) if i != longest]
    pick = cell.rng(3).choice(rest, size=k - 1, replace=False)
    return [items[longest]] + [items[i] for i in sorted(pick)]


def reference_pcm(cell: Cell, pool: FramePool, item: Judged,
                  matmul: str = "float32") -> np.ndarray:
    """The reference's PCM f32[n, hop, channels] of one item's frames."""
    ref = reference_class(cell.config)(
        cell.config["auralizer"], cell.config["live_params"], pool.device,
        phase_sum=cell.traffic["phase_sum"], matmul=matmul)
    index = item.pool_index
    return ref.run(lambda a, b: pool.on_device(index[a:b]),
                   len(index)).cpu().numpy()


def pcm_gap(cell: Cell, pool: FramePool, items: List[Judged],
            matmul: str = "float32", against=None) -> float:
    """The widest gap between each item's PCM and the reference's (or, for
    the control, between the reference at ``matmul`` and ``against``, the
    float32 reference's PCM of the same items)."""
    gap = 0.0
    for k, item in enumerate(items):
        ref = reference_pcm(cell, pool, item, matmul)
        other = item.pcm if against is None else against[k]
        if ref.shape != other.shape:
            return float("inf")
        gap = max(gap, float(np.max(np.abs(ref - other))))
    return gap


def judge(cell: Cell, pool: FramePool, judged: List[Judged],
          limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each number compared, with its limit."""
    items = sample(cell, judged)
    gap = pcm_gap(cell, pool, items) if items else float("inf")
    return {"pcm_gap": {"value": gap, "limit": float(limits["pcm_gap"])}}
