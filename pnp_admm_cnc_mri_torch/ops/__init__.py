"""Operators of the ADMM solvers: Fourier model, proxes, fused tails and iteration, metrics, schedules."""
