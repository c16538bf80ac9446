"""BM3D, the white-noise core (port of the JAX package's ``priors/bm3d/``:
``transforms.py`` and the white-noise half of ``core.py``)."""
