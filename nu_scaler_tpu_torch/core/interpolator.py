"""`WgpuFrameInterpolator` and `create_interpolator` of the port — the
counterparts of `nu_scaler_core/interpolator.py` in modes "blend" (the
reference's shipped zero-flow cross-fade, the default), "flow_soft" (the
production overlapped-tile motion-compensated mode), "flow_soft_ref" (its
mid refined by the learned net), "flow" (the hard block warp) and
"flow_exact" (the per-pixel warp): `interpolate_py`, `interpolate_multi_py`,
the timing API (`get_last_gpu_duration_ms`, `get_last_gpu_duration_detail`)
and the array methods.

`get_last_gpu_duration_ms()` returns the device time of one step of the
last `interpolate_py` call's (shape, mode): a cached calibration
(`ops.interpolate.calibrated_step_ms`, CUDA events on the card), the role of
the reference's timestamp queries. The wall time of the call itself,
synchronised with the device, is its fallback and the detail's `wall_ms`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

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
        self._last_key: Optional[tuple] = None
        self._last_wall_ms: Optional[float] = None

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
        t0 = time.perf_counter()
        out = fn(ta, tb, time_t)
        self._sync()
        self._last_wall_ms = (time.perf_counter() - t0) * 1000.0
        self._last_key = (height, width, self.mode, self.warp_tile)
        return out.cpu().numpy().tobytes()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        t0 = time.perf_counter()
        out = fn(ta, tb)
        self._sync()
        self._last_wall_ms = (time.perf_counter() - t0) * 1000.0
        self._last_key = None  # no calibration of a multi-time step
        out = out.cpu().numpy()
        return [out[i].tobytes() for i in range(out.shape[0])]

    def get_last_gpu_duration_ms(self) -> Optional[float]:
        """Device ms of one step of the last `interpolate_py` call's (shape,
        mode): a cached calibration (the first call per shape pays it);
        None before any call and after `interpolate_multi_py`. Timing never
        breaks the caller: if the calibration fails, the last call's
        synchronised wall ms is returned instead."""
        if self._last_key is None:
            return None
        try:
            return _interp.calibrated_step_ms(*self._last_key, device=self.device)
        except Exception:  # noqa: BLE001 — timing must never break the caller
            return self._last_wall_ms

    def get_last_gpu_duration_detail(self) -> Optional[dict]:
        """Per-stage device ms of the last call's (shape, mode), as
        `ops.interpolate.stage_timings_ms` gives them (total + blend, or
        total + flow + warp, and + refine for "flow_soft_ref"), plus
        `wall_ms`, the last call's synchronised wall time; the stages are
        empty if their calibration fails."""
        if self._last_key is None:
            return None
        try:
            detail = dict(_interp.stage_timings_ms(*self._last_key, device=self.device))
        except Exception:  # noqa: BLE001 — timing must never break the caller
            detail = {}
        detail["wall_ms"] = self._last_wall_ms
        return detail

    # -- the reference's array API (wgpu_interpolator.rs) ------------------

    def _unit(self, frame) -> torch.Tensor:
        """u8 frame → fp32 in [0, 1] on the interpolator's device."""
        return to_device_u8(frame, self.device).to(torch.float32) / 255.0

    def interpolate(self, frame_a, frame_b, time_t: float = 0.5) -> torch.Tensor:
        """u8 [H, W, 4] arrays in, the mid frame out (a u8 tensor on the
        interpolator's device); honours `mode`."""
        return _interp.interpolate_frames(frame_a, frame_b, time_t, self.mode, self.device)

    def build_pyramid(self, frame, levels: int = _interp.DEFAULT_PYRAMID_LEVELS) -> list:
        """Gaussian pyramid of fp32 RGBA levels in [0, 1]."""
        return _interp.build_pyramid(self._unit(frame), levels)

    def compute_coarse_flow(self, frame_a, frame_b, iters: int = _interp.DEFAULT_COARSE_ITERS,
                            lam: float = _interp.DEFAULT_LAMBDA) -> torch.Tensor:
        """Horn–Schunck flow [H, W, 2] at the frames' resolution, from zero."""
        la = _interp.luminance(self._unit(frame_a))
        lb = _interp.luminance(self._unit(frame_b))
        flow0 = torch.zeros(*la.shape, 2, dtype=torch.float32, device=self.device)
        return _interp.horn_schunck(la, lb, flow0, iters, lam)

    def refine_flow_hierarchy(self, frame_a, frame_b,
                              levels: int = _interp.DEFAULT_PYRAMID_LEVELS) -> torch.Tensor:
        """The full coarse-to-fine flow of "flow_exact" (`compute_flow`)."""
        return _interp.compute_flow(to_device_u8(frame_a, self.device),
                                    to_device_u8(frame_b, self.device), levels)


def create_interpolator(
    kind: str = "blend", workgroup_preset: Optional[str] = None, device=None
) -> WgpuFrameInterpolator:
    """Interpolator factory: kind "blend" | "flow" | "flow_soft" |
    "flow_soft_ref" | "flow_exact". Unknown kinds fall back to "blend", as
    in `nu_scaler_core`."""
    if kind not in _interp.MODES:
        kind = "blend"
    return WgpuFrameInterpolator(workgroup_preset, mode=kind, device=device)
