"""Synthetic inputs: sampling masks, k-space noise and phantoms (numpy)."""
