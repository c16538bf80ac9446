"""Inputs (numpy): images and their PNG I/O, sampling masks (generated or loaded from ``.mat``), k-space noise and phantoms."""
