"""Operators of the classical ADMM slice: Fourier model, proxes, fused tails, metrics."""
