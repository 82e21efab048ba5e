"""The benchmark of msnv_tpu_torch on one NVIDIA H100.

    python h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository's root names the cells, the configurations
and the metrics; everything that belongs to one of them sits in a file of
its own here, found by its name:

  configs/<config>.json     the configuration's sizes (its plain reference:
                            reference/samplernn.py)
  traffic/<traffic>.json    a traffic mix: the driver that runs it and its
                            parameters
  limits/<cell>.json        the limits of the numbers that decide `correct`
  drivers/<driver>.py       the loop that runs one entry point of the port
  metrics/<metric>.py       the reader of one per-layer metric

The yardstick (peaks.py, flops.py, trace.py, stats.py, inputs.py and
reference/) is frozen with the benchmark: the port under test cannot move
it. Nothing here imports jax or the JAX package.
"""
