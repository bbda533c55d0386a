"""The benchmark of ``osvos_torch`` on NVIDIA H100s.

Run from the root of a checkout:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells and metrics are listed in ``BENCHMARK.json``; everything that belongs
to one configuration, traffic mix or per-layer metric sits in a file of its
own here and is found by name (``lib/registry.py``).
"""
