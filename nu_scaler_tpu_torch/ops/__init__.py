"""Tensor ops of the port (resample, FSR, interpolation, 4:2:0 colour, metrics)."""
