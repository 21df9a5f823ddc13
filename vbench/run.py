"""The benchmark of ``vaudio_torch`` on NVIDIA GPUs: one run of one cell.

    python3 -m vbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell's frames are made on the device
from the seed and copied into pageable host memory; the cell's traffic
drives the program's entry point for ``--seconds`` after a warm-up of the
shapes it uses; the PCM the window produced is judged against the plain
reference; the last line of standard output is one JSON object: the
end-to-end metrics (``--trace 0``) or the per-layer metrics of a traced
sub-window (``--trace 1``), ``correct``, ``attempted``, ``failed`` and the
device.  Each number compared, with its limit, is printed last on
standard error and last in the JSON line (``checks``).

Exit codes: 0 a result was printed; 2 the program cannot be imported
from this checkout; 3 no CUDA device, or fewer than the cell asks for; 4
the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from vbench import manifest as mf

#: Top-level module names the measured process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "vaudio")


def process_start() -> float:
    """When this process started (``time.time()`` scale), from
    ``/proc``; the current time where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (``vaudio_torch`` is not ``vaudio``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def program_origin(root=mf.ROOT) -> Optional[str]:
    """None where ``vaudio_torch`` imports from the checkout at ``root``;
    else why not (a copy installed elsewhere is not the program under
    test)."""
    try:
        import vaudio_torch
    except ImportError as e:
        return str(e)
    origin = Path(vaudio_torch.__file__).resolve().parent.parent
    if origin != Path(root).resolve():
        return f"vaudio_torch comes from {origin}"
    return None


def log(msg: str) -> None:
    print(f"vbench: {msg}", file=sys.stderr, flush=True)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m vbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build_cell(args, started: float = None, root=mf.ROOT):
    """The :class:`vbench.drive.Cell` of a run, and its manifest entry."""
    from vbench.drive import Cell
    manifest = mf.load(root)
    entry = mf.workload(manifest, args.workload)
    cell = Cell(name=args.workload,
                config=mf.config(manifest, entry["config"], root),
                traffic=mf.traffic(entry["traffic"], root),
                seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), process_start=started)
    return cell, entry, manifest


def run_cell(cell, entry: Dict, manifest: Dict, root=mf.ROOT) -> Dict:
    """Drive the cell, judge what it produced, and make the result line
    (without ``device``'s identity keys)."""
    import torch
    from vbench.drive import DRIVERS, make_pool, pool_frames
    from vbench.judge import judge
    t0 = time.perf_counter()
    pool = make_pool(cell, pool_frames(cell))
    host = pool.to_host()
    pool.release()          # the peak read in the window is the program's
    log(f"pool of {pool.n} frames ({host.nbytes / 1e9:.2f} GB) made and "
        f"copied to the host in {time.perf_counter() - t0:.2f} s, "
        f"{time.time() - (cell.process_start or time.time()):.2f} s "
        "after start")
    driver = DRIVERS[cell.traffic["entry"]]
    outcome = driver(cell, pool, host)
    log(f"window closed: {outcome.measures}; attempted {outcome.attempted}"
        f", failed {outcome.failed}")
    del host
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = judge(cell, pool, outcome.judged, mf.limits(cell.name, root))
    log(f"judged in {time.perf_counter() - t0:.1f} s")
    for line in outcome.missing:
        log(f"not correct: {line}")
    correct = (not outcome.missing and bool(outcome.judged)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics: Dict[str, Dict] = {}
    device: Dict[str, object] = {
        "platform": "gpu", "count": int(entry["chips"]),
        "memory_peak_bytes": outcome.memory_peak_bytes}
    result: Dict[str, object] = {"correct": correct,
                                 "attempted": outcome.attempted,
                                 "failed": outcome.failed,
                                 "metrics": metrics, "device": device}
    if not cell.trace:
        measures = dict(outcome.measures,
                        memory_peak_mb=outcome.memory_peak_bytes / 1e6)
        for m in mf.end_to_end(manifest, cell.name):
            if m["name"] in measures:
                metrics[m["name"]] = {"value": measures[m["name"]],
                                      "unit": m["unit"]}
    elif outcome.trace is not None:
        tr = outcome.trace
        tr.measures = dict(outcome.measures)
        for m in mf.per_layer(manifest, cell.name):
            value = mf.metric_reader(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    args = parse(argv)
    import torch
    cell, entry, manifest = build_cell(args, started=started)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 3
    where = program_origin()
    if where is not None:
        log(f"the program cannot be imported from this checkout: {where}")
        return 2
    log(f"{args.workload} seed {args.seed} on "
        f"{torch.cuda.get_device_name()}")
    result = run_cell(cell, entry, manifest)
    found = forbidden_modules()
    if found:
        log(f"the process loaded {', '.join(found)}")
        return 4
    from vbench.counts import identity
    who = identity()
    log(f"{who['kind']} ({who['power_limit_w']} W), torch {who['torch']}, "
        f"CUDA {who['cuda']}")
    result["device"].update(who)
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
