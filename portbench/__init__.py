"""The benchmark of the PyTorch and CUDA port (``sequencealigner_tpu_torch``).

Run one cell from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are listed in BENCHMARK.json at the
root; each has files of its own here (configs/, workloads/, lengths/,
metrics/), found by name.
"""
