"""portbench: the benchmark of the PyTorch and CUDA port.

One command runs one cell once (``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``). Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own,
found by the name that ``BENCHMARK.json`` gives it.
"""
