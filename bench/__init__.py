"""The benchmark of the PyTorch / CUDA port (``repro_torch``): ``python3
bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
