"""uasl_motion_estimation_tpu_torch: the PyTorch/CUDA port of
``uasl_motion_estimation_tpu``.

The JAX package beside this one is the reference. Each module here keeps the
relative path, public names, configuration NamedTuples and input/output
layouts of its JAX counterpart, so the two can be compared function by
function. Plain tensor code is PyTorch; every Pallas TPU kernel on a ported
path is a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch
version beside it (``ops/kernels/``).

This package imports ``torch``, numpy and the standard library only: never
``jax`` and no file of the JAX package. It keeps its own copies of the
numpy-only helpers it needs (``utils/synthetic.py``, ``utils/metrics.py``,
``utils/io.py``, ``utils/sensors.py``, ``utils/viz.py``) and of the native
frame loader (``native/``). Its parallel layer (``parallel/``) runs one
process per rank under ``torch.distributed``.
Entry points run on the CUDA card unless they are given ``device="cpu"``.
"""

__version__ = "0.1.0"
