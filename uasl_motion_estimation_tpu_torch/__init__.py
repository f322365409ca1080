"""uasl_motion_estimation_tpu_torch: the PyTorch/CUDA port of
``uasl_motion_estimation_tpu``.

The JAX package beside this one is the reference. Each module here keeps the
relative path, public names, configuration NamedTuples and input/output
layouts of its JAX counterpart, so the two can be compared function by
function. Plain tensor code is PyTorch; every Pallas TPU kernel on a ported
path is a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch
version beside it (``ops/kernels/``).

This package imports ``torch`` and numpy only, never ``jax``: the numpy-only
helpers of the JAX package are loaded by file path (``_shared.py``).
"""

__version__ = "0.1.0"
