"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with a
ctypes wrapper, a launch count and a plain PyTorch version beside it."""
