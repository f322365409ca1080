"""Parallel layer of the port (so far only the host-side stitching helper)."""
