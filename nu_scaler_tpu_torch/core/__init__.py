"""The ported part of the `nu_scaler_core` API surface: every name of its
`__all__` but the capture classes (`PyScreenCapture`, `PyCaptureTarget`,
`PyWindowByTitle`, `PyRegion`) and the `NuScaler` facade."""

from nu_scaler_tpu_torch.constants import (
    QUALITY_BALANCED,
    QUALITY_PERFORMANCE,
    QUALITY_QUALITY,
    QUALITY_ULTRA,
    TECH_DLSS,
    TECH_FALLBACK,
    TECH_FSR,
    TECH_WGPU,
    VENDOR_AMD,
    VENDOR_INTEL,
    VENDOR_NVIDIA,
    VENDOR_OTHER,
    GpuVendor,
    UpscalingQuality,
    UpscalingTechnology,
)
from nu_scaler_tpu_torch.core.benchmark import (
    PyBenchmarkResult,
    py_benchmark_upscaler,
    py_run_comparison_benchmark,
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
    "PyBenchmarkResult",
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
    "py_benchmark_upscaler",
    "py_run_comparison_benchmark",
    "UpscalingQuality",
    "UpscalingTechnology",
    "GpuVendor",
    "QUALITY_ULTRA",
    "QUALITY_QUALITY",
    "QUALITY_BALANCED",
    "QUALITY_PERFORMANCE",
    "TECH_FSR",
    "TECH_DLSS",
    "TECH_WGPU",
    "TECH_FALLBACK",
    "VENDOR_NVIDIA",
    "VENDOR_AMD",
    "VENDOR_INTEL",
    "VENDOR_OTHER",
]
