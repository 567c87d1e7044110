"""Tensor ops of the port (resample, cross-fade)."""
