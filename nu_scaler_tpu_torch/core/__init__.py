"""The port's `nu_scaler_core` API surface: every name of its `__all__`, in
its order. The launcher (`nu_scaler_tpu_torch.run`) serves this package to
the app under the name `nu_scaler_core`."""

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
from nu_scaler_tpu_torch.core.capture import (
    PyCaptureTarget,
    PyRegion,
    PyScreenCapture,
    PyWindowByTitle,
)
from nu_scaler_tpu_torch.core.facade import NuScaler
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

__version__ = "0.1.0"

__all__ = [
    "PyWgpuUpscaler",
    "PyAdvancedWgpuUpscaler",
    "PyFsrUpscaler",
    "PyScreenCapture",
    "PyCaptureTarget",
    "PyWindowByTitle",
    "PyRegion",
    "PyVramStats",
    "PyBenchmarkResult",
    "NuScaler",
    "WgpuFrameInterpolator",
    "create_interpolator",
    "create_advanced_upscaler",
    "create_fsr_upscaler",
    "create_best_upscaler",
    "create_upscaler",
    "is_supported",
    "upscale_image_file",
    "PassThroughUpscaler",
    "NISUpscaler",
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
