"""The port's module constants, device detection and benchmark API
(nu_scaler_tpu_torch.constants, runtime/detector.py, bench/harness.py,
core/benchmark.py) against the JAX package's (`nu_scaler_core`,
`nu_scaler_tpu/runtime/detector.py`, `nu_scaler_tpu/bench/harness.py`), on
the CPU: the same values, keys, fields and result names. Times are the
host's and are only checked to be positive."""

import numpy as np
import pytest

import nu_scaler_core as nsc
from nu_scaler_core import _constants as jconst
from nu_scaler_tpu.bench import harness as jharness
from nu_scaler_tpu.runtime import detector as jdetector
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.bench import harness as pharness
from nu_scaler_tpu_torch import constants as pconst
from nu_scaler_tpu_torch.runtime import detector as pdetector

def test_core_exports_all_of_nu_scaler_core():
    """All 37 of nu_scaler_core's names, in its order, the capture classes
    and the facade among them, each a class or function of the same name."""
    assert pc.__all__ == nsc.__all__ and len(set(pc.__all__)) == 37
    for name in ("PyScreenCapture", "PyCaptureTarget", "PyWindowByTitle", "PyRegion", "NuScaler"):
        assert getattr(pc, name).__name__ == getattr(nsc, name).__name__ == name
    for name in pc.__all__:
        assert getattr(pc, name) is not None
    assert pc.__version__ == nsc.__version__


@pytest.mark.parametrize("enum_name", ["UpscalingQuality", "UpscalingTechnology", "GpuVendor"])
def test_enums_equal_core(enum_name):
    port, jax_side = getattr(pconst, enum_name), getattr(jconst, enum_name)
    assert [(m.name, m.value) for m in port] == [(m.name, m.value) for m in jax_side]
    if hasattr(jax_side, "parse"):
        for s in ("FSR", "dlss", "Ultra", "quality", "wgpu", "bogus", "", "Fallback", "performance"):
            assert port.parse(s).value == jax_side.parse(s).value


@pytest.mark.parametrize("prefix", ["QUALITY_", "TECH_", "VENDOR_"])
def test_constants_equal_core(prefix):
    names = [n for n in nsc.__all__ if n.startswith(prefix)]
    assert names and names == [n for n in pc.__all__ if n.startswith(prefix)]
    for name in names:
        assert getattr(pc, name).value == getattr(nsc, name).value
        assert getattr(pc, name) == getattr(nsc, name)  # both compare as their string


def test_detect_is_cached_with_jax_keys():
    det = pdetector.detect()
    assert det is pdetector.detect() and det.devices
    techs = det.detect_technologies()
    assert set(techs) == set(jdetector.DeviceDetector().detect_technologies())
    assert techs["wgpu"] and techs["fsr"] and techs["fallback"] and not techs["xess"] and not techs["vulkan"]
    assert techs["dlss"]  # the port carries the quality ladder's weights
    cpu = det.devices[-1]
    assert cpu.vendor == pc.VENDOR_OTHER and cpu.as_dict()["vendor"] == "Other"
    jcpu = jdetector._info_from_device(type("D", (), {"platform": "cpu"})(), 0)
    assert cpu.as_dict()["vendor"] == jcpu.as_dict()["vendor"]
    assert det.determine_best_upscaling_technology() in ("wgpu", "fallback")


def test_dlss_follows_the_committed_weights(monkeypatch):
    from nu_scaler_tpu_torch.core import technologies
    from nu_scaler_tpu_torch.models import esrgan_lite

    monkeypatch.setattr(esrgan_lite, "learned_tier_available", lambda prefer: False)
    assert pdetector.DeviceDetector().detect_technologies()["dlss"] is False
    assert not technologies.is_supported("dlss", "cpu") and not technologies.is_supported("xess", "cpu")


def test_test_pattern_equals_jax():
    for w, h in ((64, 32), (1920, 1080), (37, 53)):
        np.testing.assert_array_equal(pharness.generate_test_pattern(w, h), jharness.generate_test_pattern(w, h))


def test_benchmark_result_fields_equal_jax():
    """One technology through both APIs: the same attributes, names and
    sizes, the frame times positive, p50 ≤ p99."""
    got = pc.py_benchmark_upscaler("wgpu", "ultra", 64, 32, 2.0, 3, device="cpu")
    want = nsc.py_benchmark_upscaler("wgpu", "ultra", 64, 32, 2.0, 3)
    assert sorted(vars(got)) == sorted(vars(want))
    for key in ("upscaler_name", "technology", "quality", "input_width", "input_height", "output_width",
                "output_height", "scale_factor", "frames_processed"):
        assert getattr(got, key) == getattr(want, key)
    assert got.avg_frame_time_ms > 0 and got.fps > 0 and got.total_duration_ms > 0
    assert 0 < got.p50_frame_time_ms <= got.p99_frame_time_ms
    assert repr(got).startswith("PyBenchmarkResult(WgpuUpscaler Wgpu/Ultra 64x32->128x64")


def test_comparison_grid_equals_jax():
    """py_run_comparison_benchmark: the 16 cells of the grid, in the JAX
    harness's order, with its names; each cell upscales what its tier
    serves (the bytes of make_tech_upscaler's function)."""
    got = pc.py_run_comparison_benchmark(64, 32, 2.0, 1, device="cpu")
    want = nsc.py_run_comparison_benchmark(64, 32, 2.0, 1)

    def keys(results):
        return [(r.upscaler_name, r.technology, r.quality, r.input_width, r.input_height, r.output_width,
                 r.output_height, r.frames_processed) for r in results]

    assert len(got) == 16 and keys(got) == keys(want)
    assert all(sorted(vars(g)) == sorted(vars(w)) for g, w in zip(got, want))
    frame = pharness.generate_test_pattern(64, 32)
    for tech in pharness.TECHNOLOGIES:
        fn, name = pharness.make_tech_upscaler(tech, "quality", 32, 64, 64, 128, device="cpu")
        jfn, jname = jharness.make_tech_upscaler(tech, "quality", 32, 64, 64, 128)
        assert name == jname
        out = fn(frame).numpy()
        assert out.shape == (64, 128, 4)
        if tech in ("wgpu", "fallback"):
            assert np.abs(out.astype(int) - np.asarray(jfn(frame))).max() <= 2


def test_grid_skips_a_failing_cell_and_the_api_wraps_errors(monkeypatch, capsys):
    real = pharness.make_tech_upscaler

    def broken_fsr(technology, *args, **kwargs):
        if technology == "fsr":
            raise RuntimeError("no FSR here")
        return real(technology, *args, **kwargs)

    monkeypatch.setattr(pharness, "make_tech_upscaler", broken_fsr)
    got = pc.py_run_comparison_benchmark(32, 16, 2.0, 1, device="cpu")
    assert len(got) == 12 and all(r.technology != "FSR" for r in got)
    assert "Error benchmarking fsr/ultra: no FSR here" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="Benchmark error: no FSR here"):
        pc.py_benchmark_upscaler("fsr", "quality", 32, 16, 2.0, 1, device="cpu")
    with pytest.raises(ValueError, match="Test data too small"):
        pharness.benchmark_upscaler("wgpu", "ultra", 32, 16, 2.0, 1, test_data=b"\x00" * 10, device="cpu")


def test_benchmark_without_a_card_raises(monkeypatch):
    """The default device is the card: without one the API raises, it does
    not measure the CPU instead."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Benchmark error"):
        pc.py_benchmark_upscaler("wgpu", "ultra", 32, 16, 2.0, 1)
