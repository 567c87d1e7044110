"""Benchmark harness of the port — the counterpart of
`nu_scaler_tpu/bench/harness.py` (`benchmark.rs:72-272` parity), on the
port's upscalers.

Technology → tier:
  * "wgpu"     → the resample kernel, bilinear (as the reference's
                 WgpuUpscaler ships)
  * "fsr"      → EASU + RCAS (the FSR kernel at integer scales)
  * "dlss"     → the learned tier: the "performance" ladder for the
                 performance and balanced qualities, else the "quality"
                 ladder. The port carries the weights, so a failed build
                 raises (the JAX harness falls back to the resample)
  * "fallback" → nearest

Each frame is timed on the host clock around the call and a
`torch.cuda.synchronize`, so its time includes the device's work, as the
reference timed each frame around a blocking readback
(`benchmark.rs:108-122`). Every entry point runs on the card unless the
caller asks for "cpu".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.models import esrgan_lite
from nu_scaler_tpu_torch.ops import fsr as fsr_ops
from nu_scaler_tpu_torch.ops import resample
from nu_scaler_tpu_torch.ops.resample import to_device_u8

TECHNOLOGIES = ("fsr", "dlss", "wgpu", "fallback")
QUALITIES = ("ultra", "quality", "balanced", "performance")

# The debug-format names of PyBenchmarkResult.technology / .quality
# (format!("{:?}") in benchmark.rs:56-58).
TECH_DEBUG = {"fsr": "FSR", "dlss": "DLSS", "wgpu": "Wgpu", "fallback": "Fallback"}
QUALITY_DEBUG = {
    "ultra": "Ultra",
    "quality": "Quality",
    "balanced": "Balanced",
    "performance": "Performance",
}


@dataclasses.dataclass
class BenchmarkResult:
    """Field parity with `BenchmarkResult` (benchmark.rs:10-21)."""

    upscaler_name: str
    technology: str
    quality: str
    input_resolution: tuple[int, int]
    output_resolution: tuple[int, int]
    scale_factor: float
    avg_frame_time_ms: float
    fps: float
    frames_processed: int
    total_duration_ms: float
    p50_frame_time_ms: float = 0.0  # extension: BASELINE.json asks for p50
    p99_frame_time_ms: float = 0.0


def generate_test_pattern(width: int, height: int) -> np.ndarray:
    """Gradient pattern, the exact integer math of benchmark.rs:188-207."""
    x = np.arange(width, dtype=np.uint64)
    y = np.arange(height, dtype=np.uint64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[..., 0] = (x * 255 // width).astype(np.uint8)[None, :]
    img[..., 1] = (y * 255 // height).astype(np.uint8)[:, None]
    img[..., 2] = ((x[None, :] + y[:, None]) * 255 // (width + height)).astype(np.uint8)
    img[..., 3] = 255
    return img


def _normalize_tech(technology: str) -> str:
    t = (technology or "").lower()
    return t if t in TECHNOLOGIES else "fallback"  # silent default, benchmark.rs:218-224


def _normalize_quality(quality: str) -> str:
    q = (quality or "").lower()
    return q if q in QUALITIES else "quality"


def make_tech_upscaler(technology: str, quality: str, in_h: int, in_w: int, out_h: int, out_w: int,
                       device=None):
    """(u8 → u8 upscale fn on `device`, display name) for a technology and
    quality."""
    technology = _normalize_tech(technology)
    quality = _normalize_quality(quality)
    if technology == "fsr":
        return fsr_ops.make_fsr_upscaler(in_h, in_w, out_h, out_w, quality, device), "FsrUpscaler"
    if technology == "dlss":
        prefer = "performance" if quality in ("performance", "balanced") else "quality"
        return esrgan_lite.make_pretrained_upscaler(in_h, in_w, out_h, out_w, prefer, device), "LearnedUpscaler"
    algorithm = "bilinear" if technology == "wgpu" else "nearest"
    return resample.make_resampler(in_h, in_w, out_h, out_w, algorithm, device), "WgpuUpscaler"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def benchmark_upscaler(
    technology: str,
    quality: str,
    input_width: int,
    input_height: int,
    scale_factor: float,
    frame_count: int,
    test_data: Optional[Union[np.ndarray, bytes]] = None,
    device=None,
) -> BenchmarkResult:
    """`benchmark_upscaler` (benchmark.rs:72-136) on `device`: one frame
    upscaled `frame_count` times after a warm-up call, each timed to the
    device's end."""
    dev = resolve_device(device)
    if test_data is None:
        test_data = generate_test_pattern(input_width, input_height)
    if isinstance(test_data, (bytes, bytearray)):
        expected = input_width * input_height * 4
        if len(test_data) < expected:
            raise ValueError("Test data too small for the specified input resolution")
        test_data = np.frombuffer(bytes(test_data[:expected]), dtype=np.uint8).reshape(
            input_height, input_width, 4
        )

    output_width = int(round(input_width * scale_factor))
    output_height = int(round(input_height * scale_factor))
    fn, name = make_tech_upscaler(
        technology, quality, input_height, input_width, output_height, output_width, dev
    )

    frame = to_device_u8(test_data, dev)
    fn(frame)  # build and warm up outside the timed loop
    _sync(dev)

    frame_times = []
    start = time.perf_counter()
    for _ in range(frame_count):
        t0 = time.perf_counter()
        fn(frame)
        _sync(dev)
        frame_times.append((time.perf_counter() - t0) * 1000.0)
    total_ms = (time.perf_counter() - start) * 1000.0

    avg = float(np.mean(frame_times))
    return BenchmarkResult(
        upscaler_name=name,
        technology=TECH_DEBUG[_normalize_tech(technology)],
        quality=QUALITY_DEBUG[_normalize_quality(quality)],
        input_resolution=(input_width, input_height),
        output_resolution=(output_width, output_height),
        scale_factor=float(scale_factor),
        avg_frame_time_ms=avg,
        fps=1000.0 / avg if avg > 0 else float("inf"),
        frames_processed=frame_count,
        total_duration_ms=total_ms,
        p50_frame_time_ms=float(np.percentile(frame_times, 50)),
        p99_frame_time_ms=float(np.percentile(frame_times, 99)),
    )


def run_upscaler_comparison(
    input_width: int, input_height: int, scale_factor: float, frame_count: int, device=None
) -> list[BenchmarkResult]:
    """The {FSR, DLSS, Wgpu, Fallback} × {Ultra, Quality, Balanced,
    Performance} grid (benchmark.rs:139-185) on `device`. A cell that fails
    is reported and skipped, as the reference's grid does."""
    dev = resolve_device(device)
    test_data = generate_test_pattern(input_width, input_height)
    results = []
    for tech in TECHNOLOGIES:
        for quality in QUALITIES:
            try:
                results.append(
                    benchmark_upscaler(
                        tech, quality, input_width, input_height, scale_factor, frame_count, test_data, dev
                    )
                )
            except Exception as e:  # noqa: BLE001 — the grid keeps going, benchmark.rs:179
                print(f"Error benchmarking {tech}/{quality}: {e}")
    return results
