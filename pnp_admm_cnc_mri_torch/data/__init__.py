"""Inputs (numpy): images and their readers (PNG, BMP, PPM/PGM, TIFF, JPEG),
sampling masks (generated or loaded from ``.mat``), k-space noise and phantoms."""
