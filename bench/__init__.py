"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once; ``bench/README.md`` says which file to add for a
new configuration, cell or per-layer metric.
"""
