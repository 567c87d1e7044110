"""`PyWgpuUpscaler`, `PyFsrUpscaler` and `PyAdvancedWgpuUpscaler` of the
port — the API of `nu_scaler_core/upscaler.py` (the reference's PyO3 classes)
on the fused CUDA resample kernel, the fused FSR (EASU + RCAS) kernel and the
learned tier's conv kernel.

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

from nu_scaler_tpu_torch.constants import UpscalingQuality
from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.models import esrgan_lite as _learned
from nu_scaler_tpu_torch.ops import fsr as _fsr
from nu_scaler_tpu_torch.ops import resample as _resample
from nu_scaler_tpu_torch.parallel import mesh as _mesh
from nu_scaler_tpu_torch.runtime.detector import device_info
from nu_scaler_tpu_torch.runtime.memory import AllocationStrategy, MemoryPool, MemoryPressure


class PyVramStats:
    """Parity with `PyVramStats` (gpu/memory.rs:732-765)."""

    def __init__(self, total_mb: float, used_mb: float, free_mb: float, app_allocated_mb: float):
        self.total_mb = float(total_mb)
        self.used_mb = float(used_mb)
        self.free_mb = float(free_mb)
        self.app_allocated_mb = float(app_allocated_mb)
        self.usage_percent = (used_mb / total_mb) * 100.0 if total_mb > 0 else 0.0

    def __repr__(self) -> str:
        return (
            f"PyVramStats(total_mb={self.total_mb:.1f}, used_mb={self.used_mb:.1f}, "
            f"free_mb={self.free_mb:.1f}, usage={self.usage_percent:.1f}%)"
        )


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
        """The whole batch as one [N,H,W,4] upload and one batched launch; on
        a mesh of several cards (`parallel.mesh.default_mesh`), data-parallel
        over them (`upscale_batch_sharded`, as `nu_scaler_core/upscaler.py:
        157-163`)."""
        self._check_ready()
        stacked = np.stack([self._to_array(bytes(f)) for f in frames])
        out = self._batch(stacked).cpu().numpy()
        return [out[i].tobytes() for i in range(out.shape[0])]

    def _batch(self, stacked: np.ndarray) -> torch.Tensor:
        mesh = _mesh.default_mesh(self.device)
        if len(mesh) > 1:
            return _mesh.upscale_batch_sharded(
                stacked, self.output_height, self.output_width, self._algorithm, mesh)
        return self._fn(stacked)

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

    def _batch(self, stacked: np.ndarray) -> torch.Tensor:
        """One batched launch on this instance's card: the JAX package's FSR
        tier shards no batch (`nu_scaler_core/upscaler.py:471-479`)."""
        return self._fn(stacked)


def create_fsr_upscaler(quality: str, device=None) -> PyFsrUpscaler:
    """The `fsr` technology tier of the app."""
    return PyFsrUpscaler(quality, device)


class PyAdvancedWgpuUpscaler(PyWgpuUpscaler):
    """`PyAdvancedWgpuUpscaler` (`nu_scaler_core/upscaler.py:200-441`): device
    detection, memory stats, allocation strategy, adaptive quality and
    cleanup, and the learned tier.

    Quality "ultra" serves the learned network (`models/esrgan_lite.py`)
    for every request, through the conv kernel, on the ladder named by
    `learned_prefer` (set by the caller, as the app's facade does; default
    "quality"): "performance" through `make_fast_upscaler`, the others
    through `make_pretrained_upscaler`, as `nu_scaler_core/upscaler.py:244-
    248` does. The ladder picks what JAX's picks: at an exact ×2 / ×4 on a
    frame stride 4 divides, tpu4b2 / tpu4 (int8 on "quality", tpu4b1 int8
    at ×2 on "performance", bf16 on "ultra"); on a frame only stride 2
    divides, the stride-2 tpu at ×2; at another ratio the same nets' bf16
    output resized to the target; where none serves, ESRGANLite.
    `learned_prefer = "realesrgan"` serves Real-ESRGAN's RRDBNet ×2 in fp16
    (`models/rrdbnet.py`) from the weights in the trainer's `CKPT_ROOT` or
    the committed ones, and raises without them. There is
    no classical fallback. Other qualities run the classical resample
    kernel."""

    _QUALITY_RANK = {
        UpscalingQuality.ULTRA: 5,
        UpscalingQuality.QUALITY: 4,
        UpscalingQuality.BALANCED: 3,
        UpscalingQuality.PERFORMANCE: 2,
        UpscalingQuality.ULTRA_PERFORMANCE: 1,
        UpscalingQuality.NATIVE: 0,
    }
    _DOWN = {
        UpscalingQuality.ULTRA: UpscalingQuality.QUALITY,
        UpscalingQuality.QUALITY: UpscalingQuality.BALANCED,
        UpscalingQuality.BALANCED: UpscalingQuality.PERFORMANCE,
    }
    _UP = {
        UpscalingQuality.QUALITY: UpscalingQuality.ULTRA,
        UpscalingQuality.BALANCED: UpscalingQuality.QUALITY,
        UpscalingQuality.PERFORMANCE: UpscalingQuality.BALANCED,
        UpscalingQuality.ULTRA_PERFORMANCE: UpscalingQuality.PERFORMANCE,
    }

    def __init__(self, quality: str = "quality", algorithm: str = "nearest",
                 adaptive_quality: bool = True, device=None):
        super().__init__(quality, algorithm, device)
        self._adaptive_quality = bool(adaptive_quality)
        # the tier the user asked for: pressure may step below it and later
        # back up to it, never beyond
        self._requested_quality = self._quality
        self.learned_prefer = "quality"
        self._serving_tier = "classical"
        self.recommended_quality = self._quality
        self._pool = MemoryPool(self.device)
        # "force GPU activation" at construction (lib.rs:370-375)
        self._pool.force_gpu_usage()

    # -- lifecycle --------------------------------------------------------

    def initialize(
        self, input_width: int, input_height: int, output_width: int, output_height: int
    ) -> None:
        super().initialize(input_width, input_height, output_width, output_height)
        self._upscale_scale = output_width / input_width  # lib.rs:434 (width only)
        self._serving_tier = "classical"
        if self._quality == UpscalingQuality.ULTRA:
            sizes = (self.input_height, self.input_width, self.output_height, self.output_width)
            try:
                if self.learned_prefer == "performance":
                    self._fn = _learned.make_fast_upscaler(*sizes, self.device)
                else:
                    self._fn = _learned.make_pretrained_upscaler(*sizes, self.learned_prefer, self.device)
            except Exception:
                self._initialized = False  # no classical stand-in for a failed learned tier
                raise
            self._serving_tier = "learned"
        self._pool.set_allocation_strategy(AllocationStrategy.for_frame(input_width, input_height))
        self._pool.update_vram_usage(force=True)

    def _rebuild_kernel(self) -> None:
        # re-run the tier choice (classical kernel or learned tier)
        self.initialize(self.input_width, self.input_height, self.output_width, self.output_height)

    # -- core path --------------------------------------------------------

    def upscale(self, data: bytes) -> bytes:
        # pressure check before the work (lib.rs:492-501)
        if self._pool.get_current_memory_pressure() in (MemoryPressure.HIGH, MemoryPressure.CRITICAL):
            self.cleanup_memory()
        out = super().upscale(data)
        if self._adaptive_quality:
            self._update_adaptive_quality()
        return out

    def upscale_batch(self, frames: Iterable[bytes]) -> list[bytes]:
        """The learned tier takes the stacked batch through its graph in one
        pass (one launch per conv layer), on a mesh of several cards
        data-parallel over them (`parallel.mesh.esrgan_batch_sharded`, as
        `nu_scaler_core/upscaler.py:307-312`); classical tiers take the
        batched resample launch."""
        if self._serving_tier != "learned":
            return super().upscale_batch(frames)
        self._check_ready()
        stacked = np.stack([self._to_array(bytes(f)) for f in frames])
        mesh = _mesh.default_mesh(self.device)
        if len(mesh) > 1:
            out = _mesh.esrgan_batch_sharded(
                stacked, self.output_height, self.output_width, mesh, self.learned_prefer)
        else:
            out = _learned.make_pretrained_batch_upscaler(
                self.input_height, self.input_width, self.output_height, self.output_width,
                self.learned_prefer, self.device,
            )(stacked)
        out = out.cpu().numpy()
        if self._adaptive_quality:
            self._update_adaptive_quality()
        return [out[i].tobytes() for i in range(out.shape[0])]

    def _update_adaptive_quality(self) -> None:
        """The memory-pressure quality ladder (upscale/mod.rs:355-409): above
        85% usage one tier down, below 50% one tier back up toward (never
        beyond) the requested quality. A change rebuilds the serving kernel,
        so a downgraded ULTRA instance swaps the learned net for the
        classical kernel on the next call, and back."""
        pct = self._pool.get_vram_stats().usage_percent
        new_q = self._quality
        if pct > 85.0:
            new_q = self._DOWN.get(self._quality, self._quality)
        elif pct < 50.0:
            cand = self._UP.get(self._quality, self._quality)
            if self._QUALITY_RANK[cand] <= self._QUALITY_RANK[self._requested_quality]:
                new_q = cand
        self.recommended_quality = new_q
        if new_q != self._quality:
            self._quality = new_q
            if self._initialized:
                self._rebuild_kernel()

    # -- advanced features ------------------------------------------------

    def force_gpu_activation(self) -> None:
        self._pool.force_gpu_usage()
        self._pool.update_vram_usage(force=True)

    def get_vram_stats(self) -> PyVramStats:
        s = self._pool.get_vram_stats()
        return PyVramStats(s.total_mb, s.used_mb, s.free_mb, s.app_allocated_mb)

    def set_memory_strategy(self, strategy: str) -> None:
        self._pool.set_allocation_strategy(strategy)

    def get_vram_usage_percent(self) -> float:
        return self._pool.get_vram_stats().usage_percent

    @property
    def adaptive_quality(self) -> bool:
        return self._adaptive_quality

    @adaptive_quality.setter
    def adaptive_quality(self, enabled: bool) -> None:
        self._adaptive_quality = bool(enabled)

    def cleanup_memory(self) -> None:
        self._pool.cleanup_memory()

    def get_quality_str(self) -> str:
        return self._quality.value

    @property
    def quality(self) -> str:
        return self._quality.value

    @quality.setter
    def quality(self, q: str) -> None:
        self._quality = UpscalingQuality.parse(q)
        self._requested_quality = self._quality
        if self._initialized:
            self._rebuild_kernel()

    def update_gpu_stats(self) -> None:
        self._pool.update_vram_usage(force=True)

    def get_gpu_info(self) -> dict:
        """Dict-key parity with lib.rs:667-704, for the device this instance
        runs on."""
        d = device_info(self.device).as_dict()
        d["allocated_buffers"] = self._pool.get_allocated_buffers_count()
        d["allocated_bytes"] = self._pool.get_allocated_bytes()
        s = self._pool.get_vram_stats()
        d["total_vram_mb"] = s.total_mb
        d["used_vram_mb"] = s.used_mb
        d["free_vram_mb"] = s.free_mb
        return d

    def force_cleanup(self) -> None:
        self.cleanup_memory()
        self._pool.update_vram_usage(force=True)

    def get_native_device_handle(self) -> torch.device:
        """The `torch.device` this instance runs on (the role of
        `GpuResources::get_native_device_handle`, gpu/mod.rs:103-240)."""
        return self.device


def create_advanced_upscaler(quality: str, device=None) -> PyAdvancedWgpuUpscaler:
    """lib.rs:737-740."""
    return PyAdvancedWgpuUpscaler(quality, "bilinear", True, device)


def create_best_upscaler(quality: str, device=None) -> PyAdvancedWgpuUpscaler:
    """The function the reference's benchmark calls (`create_best_upscaler`,
    provided by `nu_scaler_core/upscaler.py`)."""
    return PyAdvancedWgpuUpscaler(quality, "bilinear", True, device)
