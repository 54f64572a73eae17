"""The benchmark of ``repro_torch``, the PyTorch/CUDA port, on NVIDIA H100s.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, driver or metric sits in a file
of its own, found by name (``registry.py``); see ``README.md``.
"""
