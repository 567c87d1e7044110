"""`WgpuFrameInterpolator` of the port — `interpolate_py` of
`nu_scaler_core/interpolator.py` in mode "blend" (the reference's shipped
zero-flow cross-fade). The flow modes are ROADMAP queue 1, item 8, and raise
NotImplementedError until then.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops import interpolate as _interp
from nu_scaler_tpu_torch.ops.resample import to_device_u8

_PRESETS = {
    "8x8": (8, 8),
    "square8x8": (8, 8),
    "16x16": (16, 16),
    "square16x16": (16, 16),
    "32x8": (32, 8),
    "wide32x8": (32, 8),
    "wide": (32, 8),
    "8x32": (8, 32),
    "tall8x32": (8, 32),
    "tall": (8, 32),
}


class WgpuFrameInterpolator:
    def __init__(self, workgroup_preset_str: Optional[str] = None, mode: str = "blend", device=None):
        _interp.check_mode(mode)
        preset = None
        if workgroup_preset_str is not None:
            preset = _PRESETS.get(str(workgroup_preset_str).lower())
        self.workgroup_preset = preset or (32, 8)  # default Wide32x8
        self.mode = mode
        self.device = resolve_device(device)

    def interpolate_py(
        self,
        frame_a_bytes: bytes,
        frame_b_bytes: bytes,
        width: int,
        height: int,
        *,
        time_t: float = 0.5,
    ) -> bytes:
        expected = width * height * 4
        a = bytes(frame_a_bytes)
        b = bytes(frame_b_bytes)
        if len(a) != expected or len(b) != expected:
            raise ValueError(
                f"Expected {expected} bytes per frame for {width}x{height}x4 RGBA, "
                f"got frame_a: {len(a)} bytes, frame_b: {len(b)} bytes"
            )
        fn = _interp.make_interpolator(height, width, self.mode, self.device)
        ta = to_device_u8(np.frombuffer(a, np.uint8).reshape(height, width, 4), self.device)
        tb = to_device_u8(np.frombuffer(b, np.uint8).reshape(height, width, 4), self.device)
        return fn(ta, tb, time_t).cpu().numpy().tobytes()
