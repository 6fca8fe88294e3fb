"""The benchmark of ``gsplat_tpu_torch`` on one H100 (``BENCHMARK.json``).

Run a cell with ``python3 -m gsbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. Nothing here imports ``jax`` or
``gsplat_tpu``; the reference (``gsbench/reference``) imports nothing of
``gsplat_tpu_torch`` either.
"""
