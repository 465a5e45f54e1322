"""The benchmark of the PyTorch and CUDA port, ``sph_pie_torch``, on one
NVIDIA H100: ``python3 h100bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once. See ``harness.py``."""
