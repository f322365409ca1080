"""Host-side helpers of the port: the synthetic renderer, trajectory
metrics, dataset I/O, sensor types and plots (copies of the JAX package's
numpy-only modules), the checkpoint, and profiling hooks."""
