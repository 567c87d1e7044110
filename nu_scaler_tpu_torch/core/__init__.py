"""The ported part of the `nu_scaler_core` API surface."""

from nu_scaler_tpu_torch.core._constants import (
    QUALITY_BALANCED,
    QUALITY_PERFORMANCE,
    QUALITY_QUALITY,
    QUALITY_ULTRA,
    UpscalingQuality,
)
from nu_scaler_tpu_torch.core.interpolator import WgpuFrameInterpolator, create_interpolator
from nu_scaler_tpu_torch.core.upscaler import PyFsrUpscaler, PyWgpuUpscaler, create_fsr_upscaler

__all__ = [
    "PyWgpuUpscaler",
    "PyFsrUpscaler",
    "create_fsr_upscaler",
    "WgpuFrameInterpolator",
    "create_interpolator",
    "UpscalingQuality",
    "QUALITY_ULTRA",
    "QUALITY_QUALITY",
    "QUALITY_BALANCED",
    "QUALITY_PERFORMANCE",
]
