"""The ported part of the `nu_scaler_core` API surface."""

from nu_scaler_tpu_torch.core._constants import (
    QUALITY_BALANCED,
    QUALITY_PERFORMANCE,
    QUALITY_QUALITY,
    QUALITY_ULTRA,
    UpscalingQuality,
)
from nu_scaler_tpu_torch.core.interpolator import WgpuFrameInterpolator, create_interpolator
from nu_scaler_tpu_torch.core.technologies import (
    NISUpscaler,
    PassThroughUpscaler,
    create_upscaler,
    is_supported,
    upscale_image_file,
)
from nu_scaler_tpu_torch.core.upscaler import (
    PyAdvancedWgpuUpscaler,
    PyFsrUpscaler,
    PyVramStats,
    PyWgpuUpscaler,
    create_advanced_upscaler,
    create_best_upscaler,
    create_fsr_upscaler,
)

__all__ = [
    "PyWgpuUpscaler",
    "PyFsrUpscaler",
    "PyAdvancedWgpuUpscaler",
    "PyVramStats",
    "create_fsr_upscaler",
    "create_advanced_upscaler",
    "create_best_upscaler",
    "create_upscaler",
    "is_supported",
    "upscale_image_file",
    "NISUpscaler",
    "PassThroughUpscaler",
    "WgpuFrameInterpolator",
    "create_interpolator",
    "UpscalingQuality",
    "QUALITY_ULTRA",
    "QUALITY_QUALITY",
    "QUALITY_BALANCED",
    "QUALITY_PERFORMANCE",
]
