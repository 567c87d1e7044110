"""The native frame ring of the port's capture stack: the counterpart of
`nu_scaler_tpu/runtime/framering.py`, a ctypes binding of
`runtime/native/framering.cpp` (host C++, built by g++ at the first use into
``build/nu_scaler_tpu_torch/``, `kernels/_build.py`).

This is the capture pipeline's hot path: the producer thread pushes frames
into native code (no GIL contention on the copy), the consumer drains to the
latest frame (realtime.rs:496-530 semantics). When the library cannot be
built, `native_available()` is False, `build_error` holds why, and the
capture stack uses the pure-Python `capture.sources.FrameRing`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from nu_scaler_tpu_torch.kernels import _build

_lib = None
# why the library could not be built or loaded, once a first use failed
build_error: Optional[str] = None
_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, build_error
    with _lock:
        if _lib is None and build_error is None:
            try:
                _lib = _build.load_library("framering")
            except _build.HOST_BUILD_ERRORS as e:
                build_error = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


class NativeFrameRing:
    """Drop-in for `capture.sources.FrameRing` backed by C++."""

    def __init__(self, capacity: int = 5, max_frame_bytes: int = 3840 * 2160 * 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native frame ring unavailable: {build_error}")
        self._lib = lib
        self._ring = lib.nu_ring_create(capacity)
        self._buf = np.empty(max_frame_bytes, dtype=np.uint8)

    def push(self, frame: Tuple[bytes, int, int]) -> None:
        data, w, h = frame
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size != w * h * 4:
            # the C side copies w*h*4 bytes unconditionally; a short buffer
            # would be an out-of-bounds read in native code
            raise ValueError(
                f"frame buffer is {arr.size} bytes, expected {w * h * 4} for {w}x{h} RGBA"
            )
        self._lib.nu_ring_push(self._ring, _ptr(arr), w, h)

    def push_array(self, arr: np.ndarray) -> None:
        h, w = arr.shape[:2]
        arr = np.ascontiguousarray(arr)
        if arr.nbytes != w * h * 4:
            raise ValueError(
                f"frame array is {arr.nbytes} bytes, expected {w * h * 4} for {w}x{h} RGBA"
            )
        self._lib.nu_ring_push(self._ring, _ptr(arr), w, h)

    def latest(self) -> Optional[Tuple[bytes, int, int]]:
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        trunc = ctypes.c_int()
        ok = self._lib.nu_ring_latest(
            self._ring, _ptr(self._buf), self._buf.nbytes,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(trunc),
        )
        if not ok or trunc.value:
            return None
        n = w.value * h.value * 4
        return bytes(self._buf[:n].tobytes()), w.value, h.value

    @property
    def frames_pushed(self) -> int:
        return int(self._lib.nu_ring_pushed(self._ring))

    @property
    def frames_dropped(self) -> int:
        return int(self._lib.nu_ring_dropped(self._ring))

    def __len__(self) -> int:  # latest() drains everything; approximation
        return 1 if self.frames_pushed else 0

    def __del__(self):
        try:
            self._lib.nu_ring_destroy(self._ring)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def bgra_to_rgba(bgra: np.ndarray) -> np.ndarray:
    """Native BGRA→RGBA swizzle; numpy fallback."""
    lib = _load()
    flat = np.ascontiguousarray(bgra)
    if lib is None:
        return flat[..., [2, 1, 0, 3]].copy()
    out = np.empty_like(flat)
    lib.nu_bgra_to_rgba(_ptr(flat), _ptr(out), flat.size // 4)
    return out


def native_test_pattern(width: int, height: int, tick: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {build_error}")
    out = np.empty((height, width, 4), dtype=np.uint8)
    lib.nu_test_pattern(_ptr(out), width, height, tick)
    return out
