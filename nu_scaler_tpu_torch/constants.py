"""Module constants of the ported API — the port's own copy of
`nu_scaler_core/_constants.py` (the reference's pymodule registration,
`nu_scaler_core/src/lib.rs:746-761`). A leaf module: the API layer (`core`)
re-exports it and the runtime layer (`runtime/detector.py`) reads it.

Str-derived enum members both compare as tokens and remain valid constructor
arguments (every reference constructor parses case-insensitive strings).
"""

from __future__ import annotations

import enum


class UpscalingQuality(str, enum.Enum):
    ULTRA = "ultra"
    QUALITY = "quality"
    BALANCED = "balanced"
    PERFORMANCE = "performance"
    ULTRA_PERFORMANCE = "ultra_performance"
    NATIVE = "native"

    def __str__(self) -> str:  # debug-format name, e.g. "Ultra"
        return self.value

    @staticmethod
    def parse(s: str) -> "UpscalingQuality":
        """Case-insensitive with silent fallback to Quality."""
        try:
            return UpscalingQuality(str(s).lower())
        except ValueError:
            return UpscalingQuality.QUALITY


class UpscalingTechnology(str, enum.Enum):
    FSR = "fsr"
    DLSS = "dlss"
    WGPU = "wgpu"
    FALLBACK = "fallback"

    @staticmethod
    def parse(s: str) -> "UpscalingTechnology":
        """Case-insensitive with silent fallback to Fallback."""
        try:
            return UpscalingTechnology(str(s).lower())
        except ValueError:
            return UpscalingTechnology.FALLBACK


class GpuVendor(str, enum.Enum):
    NVIDIA = "nvidia"
    AMD = "amd"
    INTEL = "intel"
    GOOGLE = "google"
    OTHER = "other"


QUALITY_ULTRA = UpscalingQuality.ULTRA
QUALITY_QUALITY = UpscalingQuality.QUALITY
QUALITY_BALANCED = UpscalingQuality.BALANCED
QUALITY_PERFORMANCE = UpscalingQuality.PERFORMANCE

TECH_FSR = UpscalingTechnology.FSR
TECH_DLSS = UpscalingTechnology.DLSS
TECH_WGPU = UpscalingTechnology.WGPU
TECH_FALLBACK = UpscalingTechnology.FALLBACK

VENDOR_NVIDIA = GpuVendor.NVIDIA
VENDOR_AMD = GpuVendor.AMD
VENDOR_INTEL = GpuVendor.INTEL
VENDOR_OTHER = GpuVendor.OTHER
