"""The benchmark of npe_tpu_torch, the PyTorch and CUDA port: `python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
