"""Denoiser networks (port of the JAX package's ``models/``)."""
