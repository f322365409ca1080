"""Nonlinear least-squares solvers of the port."""
