"""nu_scaler_tpu_torch — the PyTorch + CUDA port of the nu_scaler engine.

Runs the 1080p→4K resample, the cross-fade live step, the frame generation
modes ("flow_soft", its learned refinement "flow_soft_ref", "flow" and
"flow_exact"), the FSR tier and the learned tier (the int8 "quality" and
"performance" ladders and the bf16 "ultra" one) on an NVIDIA Hopper card,
through hand-written CUDA kernels (`kernels/csrc/*.cu`); the flow stage is
plain PyTorch. Beside them: the capture stack and the native frame ring and
Y4M demuxer (host C++, `runtime/native/*.cpp`), the full `nu_scaler_core` API
(`core`), and a launcher that runs the app (`nu_scaler`) on the port
(`python -m nu_scaler_tpu_torch.run`). Imports torch and numpy only: nothing
of the JAX package (`nu_scaler_tpu`, `nu_scaler_core`) is imported here or
below.
"""

from nu_scaler_tpu_torch.device import default_device, resolve_device, set_default_device

__all__ = ["default_device", "resolve_device", "set_default_device"]
