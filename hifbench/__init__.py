"""hifbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python hifbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
measures one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
"""
