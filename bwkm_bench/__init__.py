"""The benchmark of the PyTorch/CUDA port of BWKM (``src/repro_torch``).

One command runs one cell once, from the root of a checkout:

    python3 -m bwkm_bench.run --workload susy.fit --seed 7 --seconds 40 --trace 0

``BENCHMARK.json`` at the root names the cells; everything else is found by
name under this folder:

* ``configs/<config>.json`` — the dataset of a deployment (shape, source,
  what was assumed), read by :mod:`bwkm_bench.data`;
* ``traffic/<mix>.json`` — the parameters of a traffic mix; its ``kind``
  names the loop of :mod:`bwkm_bench.loops` that drives the port;
* ``limits/<workload>.json`` — the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py`` — one reader a metric, ``read(record)``;
* ``reference/`` — the plain reference (PyTorch in float64; nothing of the
  port), ``counts/`` — the operations, bytes and peaks of the rooflines.

Nothing here imports JAX or the JAX package ``repro``.
"""
