"""The benchmark API of the port — the counterpart of
`nu_scaler_core/benchmark.py` (`py_benchmark_upscaler`,
`py_run_comparison_benchmark`, `PyBenchmarkResult`; benchmark.rs:24-272), on
`bench/harness.py`. Every entry point runs on the card unless the caller
asks for "cpu"."""

from __future__ import annotations

from nu_scaler_tpu_torch.bench import harness as _harness


class PyBenchmarkResult:
    """Attribute parity with `PyBenchmarkResult` (benchmark.rs:24-50)."""

    def __init__(self, r: _harness.BenchmarkResult):
        self.upscaler_name = r.upscaler_name
        self.technology = r.technology
        self.quality = r.quality
        self.input_width = r.input_resolution[0]
        self.input_height = r.input_resolution[1]
        self.output_width = r.output_resolution[0]
        self.output_height = r.output_resolution[1]
        self.scale_factor = r.scale_factor
        self.avg_frame_time_ms = r.avg_frame_time_ms
        self.fps = r.fps
        self.frames_processed = r.frames_processed
        self.total_duration_ms = r.total_duration_ms
        # extensions (BASELINE.json metrics)
        self.p50_frame_time_ms = r.p50_frame_time_ms
        self.p99_frame_time_ms = r.p99_frame_time_ms

    def __repr__(self) -> str:
        return (
            f"PyBenchmarkResult({self.upscaler_name} {self.technology}/{self.quality} "
            f"{self.input_width}x{self.input_height}->{self.output_width}x{self.output_height} "
            f"{self.fps:.1f} fps)"
        )


def py_benchmark_upscaler(
    technology: str,
    quality: str,
    input_width: int,
    input_height: int,
    scale_factor: float,
    frame_count: int,
    device=None,
) -> PyBenchmarkResult:
    try:
        r = _harness.benchmark_upscaler(
            technology, quality, input_width, input_height, scale_factor, frame_count, device=device
        )
    except Exception as e:  # noqa: BLE001 — the API reports every failure as RuntimeError
        raise RuntimeError(f"Benchmark error: {e}") from e
    return PyBenchmarkResult(r)


def py_run_comparison_benchmark(
    input_width: int, input_height: int, scale_factor: float, frame_count: int, device=None
) -> list[PyBenchmarkResult]:
    try:
        results = _harness.run_upscaler_comparison(
            input_width, input_height, scale_factor, frame_count, device
        )
    except Exception as e:  # noqa: BLE001 — the API reports every failure as RuntimeError
        raise RuntimeError(f"Benchmark error: {e}") from e
    return [PyBenchmarkResult(r) for r in results]
