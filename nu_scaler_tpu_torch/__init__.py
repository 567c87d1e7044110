"""nu_scaler_tpu_torch — the PyTorch + CUDA port of the nu_scaler engine.

Runs the 1080p→4K resample, the cross-fade live step, the
motion-compensated "flow_soft" frame generation, the FSR tier and the learned
"ultra" tier on an NVIDIA Hopper card, through hand-written CUDA kernels
(`kernels/csrc/*.cu`); the flow stage is plain PyTorch. Imports torch and
numpy only: nothing of the JAX package (`nu_scaler_tpu`, `nu_scaler_core`) is
imported here or below.
"""

from nu_scaler_tpu_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
