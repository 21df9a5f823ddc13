"""The readings a cell's limit is set from, in one process:

    python3 -m vbench.readings --workload <cell> --seeds 1,2,...,12 \\
        --control 3 --seconds <s>

For every seed, a run of the cell as ``vbench.run`` makes it (no trace)
and its ``pcm_gap`` against the plain reference: the sound runs, whose
largest gap is the lower reading.  For the first ``--control`` seeds also
the control's gap: the reference put in the program's place, computed
with TF32 matrix products, against the float32 reference on the same
items; the smallest is the upper reading.  One JSON line a seed, then a
summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from vbench.run import build_cell, forbidden_modules, log, process_start


def readings(cell, control: bool) -> dict:
    """One seed's sound gap and, with ``control``, the control's gap."""
    import torch
    from vbench.drive import DRIVERS, make_pool, pool_frames
    from vbench.judge import reference_pcm, sample
    pool = make_pool(cell, pool_frames(cell))
    host = pool.to_host()
    outcome = DRIVERS[cell.traffic["entry"]](cell, pool, host)
    del host
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    items = sample(cell, outcome.judged)
    out = {"seed": cell.seed, "missing": outcome.missing,
           "hops": int(sum(len(i.pool_index) for i in items)),
           "measures": outcome.measures}
    sound, ctrl = 0.0, 0.0
    for item in items:
        ref = reference_pcm(cell, pool, item)
        sound = max(sound, float(np.max(np.abs(item.pcm - ref))))
        if control:
            low = reference_pcm(cell, pool, item, matmul="tf32")
            ctrl = max(ctrl, float(np.max(np.abs(low - ref))))
    out["pcm_gap"] = sound
    if control:
        out["control_pcm_gap"] = ctrl
    return out


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(prog="python3 -m vbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for k, seed in enumerate(seeds):
        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=args.seconds, trace=0)
        cell, _entry, _m = build_cell(ns, started=started)
        t0 = time.perf_counter()
        row = readings(cell, control=k < args.control)
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    sound = [r["pcm_gap"] for r in rows if not r["missing"]]
    ctrl = [r["control_pcm_gap"] for r in rows if "control_pcm_gap" in r]
    print(json.dumps({"workload": args.workload, "seeds": len(sound),
                      "lower": max(sound) if sound else None,
                      "upper": min(ctrl) if ctrl else None,
                      "forbidden": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
