"""Operators: the Fourier model, proxes, fused tails and iteration, metrics, schedules, and the SR/deblurring operators and bicubic resize."""
