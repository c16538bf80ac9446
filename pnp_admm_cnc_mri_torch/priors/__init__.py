"""Denoiser priors and their test-mode wrappers (port of the JAX package's ``priors/``)."""
