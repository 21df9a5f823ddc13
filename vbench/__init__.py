"""vbench — the benchmark of ``vaudio_torch`` on NVIDIA GPUs.

``python3 -m vbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``python3 -m
vbench.readings`` takes the readings a cell's limit is set from.  The
cells, configurations, traffic mixes, limits and per-layer metrics are
files of their own under this folder, found by the names in
``BENCHMARK.json`` (:mod:`vbench.manifest`).  Nothing here imports JAX or
the JAX package; the plain reference (:mod:`vbench.reference`) imports
nothing of the program either.
"""
