"""`PyWgpuUpscaler` and `PyFsrUpscaler` of the port — the API of
`nu_scaler_core/upscaler.py` (the reference's PyO3 class) on the fused CUDA
resample kernel and the fused FSR (EASU + RCAS) kernel.

Contracts kept: case-insensitive constructor strings with silent fallbacks;
`initialize` sets upscale_scale to the mean of the axis scales; the
`upscale_scale` setter raises ValueError outside [1.0, 4.0]; `upscale` raises
RuntimeError when uninitialized or on a size mismatch, with the reference's
message text; output bytes are RGBA u8 of length out_w*out_h*4.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from nu_scaler_tpu_torch.core._constants import UpscalingQuality
from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.ops import fsr as _fsr
from nu_scaler_tpu_torch.ops import resample as _resample


class PyWgpuUpscaler:
    """quality: ultra|quality|balanced|performance; algorithm: nearest|
    bilinear (+ the legacy tiers). Runs on `device` (the card unless "cpu")."""

    def __init__(self, quality: str = "quality", algorithm: str = "nearest", device=None):
        self._quality = UpscalingQuality.parse(quality)
        self._algorithm = _resample.normalize_algorithm(algorithm)
        self.device = resolve_device(device)
        self._upscale_scale = 2.0
        self._initialized = False
        self._fn = None
        self.input_width = 0
        self.input_height = 0
        self.output_width = 0
        self.output_height = 0
        # compat knobs of the reference; stored and surfaced, no thread pool
        # exists (a batch is one kernel launch)
        self._thread_count = 4
        self._buffer_pool_size = 3
        self._gpu_allocator = "default"
        self._shader_path = ""

    # -- lifecycle --------------------------------------------------------

    def initialize(
        self, input_width: int, input_height: int, output_width: int, output_height: int
    ) -> None:
        if input_width > 0 and input_height > 0:
            self._upscale_scale = (
                output_width / input_width + output_height / input_height
            ) / 2.0
        if min(input_width, input_height, output_width, output_height) <= 0:
            raise RuntimeError("Invalid dimensions: all must be positive")
        self.input_width = int(input_width)
        self.input_height = int(input_height)
        self.output_width = int(output_width)
        self.output_height = int(output_height)
        self._fn = self._cached_kernel()
        self._initialized = True

    def _cached_kernel(self):
        """This tier's kernel for the current sizes, shared through the cache."""
        return _resample.make_resampler(
            self.input_height, self.input_width, self.output_height, self.output_width,
            self._algorithm, self.device,
        )

    def _rebuild_kernel(self) -> None:
        """Rebuild only this instance's kernel, bypassing the shared cache
        (subclasses rebuild their own tier)."""
        self._fn = _resample.Resampler(
            self.input_height, self.input_width,
            self.output_height, self.output_width, self._algorithm, self.device,
        )

    # -- properties -------------------------------------------------------

    @property
    def upscale_scale(self) -> float:
        return self._upscale_scale

    @upscale_scale.setter
    def upscale_scale(self, scale: float) -> None:
        if scale < 1.0 or scale > 4.0:
            raise ValueError("Scale factor must be between 1.0 and 4.0")
        self._upscale_scale = float(scale)

    @property
    def name(self) -> str:
        return "WgpuUpscaler"

    @property
    def algorithm(self) -> str:
        return self._algorithm

    # -- core path --------------------------------------------------------

    def _to_array(self, data: bytes) -> np.ndarray:
        expected = self.input_width * self.input_height * 4
        if len(data) != expected:
            raise RuntimeError(
                f"Input data size ({len(data)}) does not match expected input buffer "
                f"size ({expected} for {self.input_width}x{self.input_height})"
            )
        # a writable copy: torch must not alias the caller's immutable bytes
        return np.frombuffer(data, dtype=np.uint8).reshape(
            self.input_height, self.input_width, 4
        ).copy()

    def _check_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("Upscaler not initialized. Call initialize() first.")

    def upscale(self, data: bytes) -> bytes:
        """Single-frame hot path: one upload, one kernel launch, one download."""
        self._check_ready()
        out = self._fn(self._to_array(bytes(data)))
        return out.cpu().numpy().tobytes()

    def upscale_arr(self, arr) -> torch.Tensor:
        """Array in, device tensor out: the zero-readback path the streaming
        pipeline uses."""
        self._check_ready()
        return self._fn(arr)

    def upscale_batch(self, frames: Iterable[bytes]) -> list[bytes]:
        """The whole batch as one [N,H,W,4] upload and one batched launch."""
        self._check_ready()
        stacked = np.stack([self._to_array(bytes(f)) for f in frames])
        out = self._fn(stacked).cpu().numpy()
        return [out[i].tobytes() for i in range(out.shape[0])]

    # -- compat knobs -----------------------------------------------------

    def reload_shader(self, path: str) -> None:
        """Shader hot-reload compat: there is no WGSL to reload; this
        instance's kernel is rebuilt fresh, bypassing the shared cache."""
        self._shader_path = str(path)
        if self._initialized:
            self._rebuild_kernel()

    def set_thread_count(self, n: int) -> None:
        if n > 0:
            self._thread_count = int(n)

    def set_buffer_pool_size(self, n: int) -> None:
        if n > 0:
            self._buffer_pool_size = int(n)

    def set_gpu_allocator(self, preset: str) -> None:
        self._gpu_allocator = str(preset)


class PyFsrUpscaler(PyWgpuUpscaler):
    """The FSR tier: EASU + RCAS (`ops/fsr.py`), one launch of the fused
    kernel per frame or per batch at integer scales. A failed launch raises;
    there is no per-frame fallback."""

    def __init__(self, quality: str = "quality", device=None):
        super().__init__(quality, "bilinear", device)

    @property
    def name(self) -> str:
        return "FsrUpscaler"

    def _cached_kernel(self):
        return _fsr.make_fsr_upscaler(
            self.input_height, self.input_width, self.output_height, self.output_width,
            self._quality.value, self.device,
        )

    def _rebuild_kernel(self) -> None:
        self._fn = _fsr.FsrUpscaler(
            self.input_height, self.input_width, self.output_height, self.output_width,
            self._quality.value, self.device,
        )


def create_fsr_upscaler(quality: str, device=None) -> PyFsrUpscaler:
    """The `fsr` technology tier of the app."""
    return PyFsrUpscaler(quality, device)
