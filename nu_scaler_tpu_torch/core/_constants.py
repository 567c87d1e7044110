"""Module constants the ported API needs — the port's own copy of
`UpscalingQuality` from `nu_scaler_core/_constants.py`.

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


QUALITY_ULTRA = UpscalingQuality.ULTRA
QUALITY_QUALITY = UpscalingQuality.QUALITY
QUALITY_BALANCED = UpscalingQuality.BALANCED
QUALITY_PERFORMANCE = UpscalingQuality.PERFORMANCE
