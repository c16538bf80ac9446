"""Experiment pipelines of the port: the MRI experiment runners and the DPIR restoration pipelines (``experiments.py``) and the scenario sweep (``sweep.py``)."""
