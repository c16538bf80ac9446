"""BM3D (port of the JAX package's ``priors/bm3d/``): ``transforms.py``,
``core.py`` (the white-noise core and the colored-noise half),
``psd_params.py`` (PSD parameter estimation) and ``api.py`` (the
reference-compatible entry points)."""
