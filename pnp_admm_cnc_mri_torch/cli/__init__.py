"""Experiment pipelines of the port: the DPIR restoration pipelines (``experiments.py``)."""
