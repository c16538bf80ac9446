"""Denoiser training (port of the JAX package's ``train/``)."""
