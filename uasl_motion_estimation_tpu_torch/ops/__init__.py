"""Device ops of the port: geometry, rotation algebra, image ops, stereo
matching, minimal pose solvers, and the hand-written kernels."""
