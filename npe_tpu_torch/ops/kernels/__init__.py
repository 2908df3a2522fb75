"""Hand-written CUDA kernels (sources in `npe_tpu_torch/csrc/`), each beside
its plain PyTorch version. A wrapper runs the plain version for a tensor on
the CPU, and for a tensor on the GPU launches its kernel or raises."""
