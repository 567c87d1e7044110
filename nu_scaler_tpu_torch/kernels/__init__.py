"""Kernels of the port: one CUDA source (csrc/resample_fused.cu), its ctypes build, wrappers and numpy goldens."""
