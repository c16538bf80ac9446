"""Reductions over the batch and the single-device consensus solvers."""
