"""The benchmark of ``wiki_grx_gym_tpu_torch``: compiled PPO training on NVIDIA H100.

    python3 -m benchmark.run --workload gr1t1.plane --seed 7 --seconds 40 --trace 0

Everything a cell is made of is a file found by name: the cells are the
``workloads`` of ``BENCHMARK.json``, a configuration is
``benchmark/configs/<name>.json``, a traffic mix ``benchmark/traffic/<name>.json``,
a cell's limits ``benchmark/limits/<cell>.json`` and a per-layer metric's
reader ``benchmark/metrics/<name>.py`` (:mod:`benchmark.spec`).

Only :mod:`benchmark.program` imports the port. The plain reference
(``benchmark/reference``) imports neither the port nor JAX.
"""
