"""The benchmark of the PyTorch and CUDA port, ``repro_torch``, on the
NVIDIA H100: run a cell with ``python3 chipbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the repository's root."""
