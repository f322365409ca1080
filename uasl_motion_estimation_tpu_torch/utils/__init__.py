"""Host-side numpy helpers of the port: the synthetic renderer and the
trajectory metrics (copies of the JAX package's numpy-only modules)."""
