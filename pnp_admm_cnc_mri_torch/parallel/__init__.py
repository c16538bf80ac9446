"""Reductions over the batch (single device in this slice)."""
