"""vobench: the benchmark of the PyTorch/CUDA visual-odometry port.

One run measures one cell of ``BENCHMARK.json``:
``python -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``.
"""
