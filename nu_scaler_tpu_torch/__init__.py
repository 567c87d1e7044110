"""nu_scaler_tpu_torch — the PyTorch + CUDA port of the nu_scaler engine.

Runs the 1080p→4K resample and the cross-fade live step on an NVIDIA Hopper
card through one hand-written CUDA kernel
(`kernels/csrc/resample_fused.cu`). Imports torch and numpy only: nothing of
the JAX package (`nu_scaler_tpu`, `nu_scaler_core`) is imported here or below.
"""

from nu_scaler_tpu_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
