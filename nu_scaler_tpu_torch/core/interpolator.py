"""`WgpuFrameInterpolator` and `create_interpolator` of the port — the
counterparts of `nu_scaler_core/interpolator.py` in modes "blend" (the
reference's shipped zero-flow cross-fade, the default) and "flow_soft" (the
production overlapped-tile motion-compensated mode): `interpolate_py` and
`interpolate_multi_py`. The modes "flow" and "flow_exact" (ROADMAP queue 1,
item 8) and "flow_soft_ref" (item 10) raise NotImplementedError.
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
        # the warp pass's block shape: rows = preset y, cols = 4 · preset x
        # (the default Wide32x8 gives the (8, 128) tile)
        self.warp_tile = (self.workgroup_preset[1], 4 * self.workgroup_preset[0])
        self.mode = mode
        self.device = resolve_device(device)

    def _frames(self, frame_a_bytes, frame_b_bytes, width: int, height: int):
        expected = width * height * 4
        a = bytes(frame_a_bytes)
        b = bytes(frame_b_bytes)
        if len(a) != expected or len(b) != expected:
            raise ValueError(
                f"Expected {expected} bytes per frame for {width}x{height}x4 RGBA, "
                f"got frame_a: {len(a)} bytes, frame_b: {len(b)} bytes"
            )
        return tuple(
            to_device_u8(np.frombuffer(x, np.uint8).reshape(height, width, 4), self.device)
            for x in (a, b)
        )

    def interpolate_py(
        self,
        frame_a_bytes: bytes,
        frame_b_bytes: bytes,
        width: int,
        height: int,
        *,
        time_t: float = 0.5,
    ) -> bytes:
        ta, tb = self._frames(frame_a_bytes, frame_b_bytes, width, height)
        fn = _interp.make_interpolator(height, width, self.mode, self.device, self.warp_tile)
        return fn(ta, tb, time_t).cpu().numpy().tobytes()

    def interpolate_multi_py(
        self,
        frame_a_bytes: bytes,
        frame_b_bytes: bytes,
        width: int,
        height: int,
        *,
        times: tuple = (1.0 / 3.0, 2.0 / 3.0),
    ) -> list:
        """N-factor frame generation: one motion solve, one in-between frame
        per entry of `times` (each in [0, 1]), as a list of RGBA byte frames
        ordered as `times`."""
        ta, tb = self._frames(frame_a_bytes, frame_b_bytes, width, height)
        ts = tuple(float(t) for t in times)
        if not ts or not all(0.0 <= t <= 1.0 for t in ts):
            raise ValueError(f"times must be non-empty, each in [0, 1]: {times!r}")
        # as nu_scaler_core: a mode without a multi-time form serves flow_soft
        mode = self.mode if self.mode in ("blend", "flow", "flow_soft", "flow_soft_ref") else "flow_soft"
        fn = _interp.make_multi_interpolator(height, width, ts, mode, self.device, self.warp_tile)
        out = fn(ta, tb).cpu().numpy()
        return [out[i].tobytes() for i in range(out.shape[0])]


def create_interpolator(
    kind: str = "blend", workgroup_preset: Optional[str] = None, device=None
) -> WgpuFrameInterpolator:
    """Interpolator factory: kind "blend" | "flow_soft" (and the kinds not
    ported yet, which raise NotImplementedError). Unknown kinds fall back to
    "blend", as in `nu_scaler_core`."""
    if kind not in _interp.MODES:
        kind = "blend"
    return WgpuFrameInterpolator(workgroup_preset, mode=kind, device=device)
