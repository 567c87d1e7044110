"""The port's timing (nu_scaler_tpu_torch.utils.tracing.device_timer,
`calibrated_step_ms` / `stage_timings_ms`, and WgpuFrameInterpolator's
timing and array methods) on the CPU, against the JAX package's keys and
values. The port's spans are tested in tests/test_torch_spans.py.

Times measured here are host-clock times of PyTorch's CPU kernels: the tests
check structure (keys, caching, chaining, fallbacks), never speed. The array
methods hold the JAX API's outputs: pyramids ≤ 1e-6, flows ≤ 1e-3 px, the
mid frame ≤ 1 LSB (tests/test_torch_flow_modes.py states why).
"""

import numpy as np
import pytest
import torch

import nu_scaler_core as nsc
from nu_scaler_tpu.ops import interpolate as J
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.ops import interpolate as P
from nu_scaler_tpu_torch.utils import tracing as ptracing

H, W = 32, 256
# the keys of nu_scaler_tpu.ops.interpolate.stage_timings_ms per mode, as
# WgpuFrameInterpolator.get_last_gpu_duration_detail adds "wall_ms"
JAX_STAGE_KEYS = {
    "blend": {"total_ms", "blend_ms"},
    "flow": {"total_ms", "flow_ms", "warp_ms"},
    "flow_soft": {"total_ms", "flow_ms", "warp_ms"},
    "flow_exact": {"total_ms", "flow_ms", "warp_ms"},
}


def _frames(seed: int = 0, h: int = H, w: int = W):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 4), np.uint8)
    return a, np.roll(a, 3, axis=1)


def test_device_timer_chains_the_state():
    seen = []

    def body(s):
        seen.append(int(s[0].item()))
        return s + 1

    secs = ptracing.device_timer(body, torch.zeros(2), iters=5)
    assert secs > 0
    # each step consumed the last one's output, warm-ups first
    assert seen == list(range(ptracing._WARMUP_STEPS + 5))


def test_device_timer_takes_tuples_and_needs_a_tensor():
    secs = ptracing.device_timer(lambda s: (s[1], s[0] + s[1], s[2]), (torch.ones(3), torch.ones(3), 0.5),
                                 iters=3)
    assert secs > 0
    with pytest.raises(ValueError, match="at least one tensor"):
        ptracing.device_timer(lambda s: s, (1.0, 2.0))


@pytest.mark.parametrize("mode", sorted(JAX_STAGE_KEYS))
def test_stage_timings_keys_per_mode(mode):
    """The JAX function's keys; the total is the cached calibration."""
    total = P.calibrated_step_ms(H, W, mode, device="cpu", iters=2)
    assert total > 0
    assert P.calibrated_step_ms(H, W, mode, device="cpu", iters=2) == total  # cached
    stages = P.stage_timings_ms(H, W, mode, device="cpu", iters=2)
    assert set(stages) == JAX_STAGE_KEYS[mode]
    assert stages["total_ms"] == total and all(v > 0 for v in stages.values())


def test_stage_timings_keys_equal_jax_blend():
    """JAX's own stage timings at a tiny blend step: the same keys."""
    assert set(J.stage_timings_ms(8, 16, "blend", iters=2)) == set(
        P.stage_timings_ms(8, 16, "blend", device="cpu", iters=2))


def test_flow_soft_warp_stage_runs_the_kernel_wrapper(monkeypatch):
    """flow_soft's warp stage on a frame the tile divides calls the soft
    warp kernel's wrapper (on the CPU, its plain version)."""
    calls = []
    real = P.soft_warp_blend

    def spy(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(P, "soft_warp_blend", spy)
    stages = P._stage_timings_ms(16, 256, "flow_soft", P.WARP_TILE, 2, torch.device("cpu"))
    assert set(stages) == JAX_STAGE_KEYS["flow_soft"]
    assert calls and all(tuple(s) == (2, 2, 2) for s in calls)


@pytest.mark.parametrize("mode", sorted(JAX_STAGE_KEYS))
def test_interpolator_timing_api(mode):
    a, b = _frames()
    fi = pc.WgpuFrameInterpolator(mode=mode, device="cpu")
    assert fi.get_last_gpu_duration_ms() is None and fi.get_last_gpu_duration_detail() is None
    fi.interpolate_py(a.tobytes(), b.tobytes(), W, H)
    ms = fi.get_last_gpu_duration_ms()
    assert ms == P.calibrated_step_ms(H, W, mode, fi.warp_tile, device="cpu") > 0
    detail = fi.get_last_gpu_duration_detail()
    jf = nsc.WgpuFrameInterpolator(mode=mode)
    assert set(detail) == JAX_STAGE_KEYS[mode] | {"wall_ms"}
    assert detail["total_ms"] == ms and detail["wall_ms"] == fi._last_wall_ms > 0
    # after interpolate_multi_py there is no calibrated key, as in JAX
    fi.interpolate_multi_py(a.tobytes(), b.tobytes(), W, H)
    jf.interpolate_multi_py(a.tobytes(), b.tobytes(), W, H)
    assert fi.get_last_gpu_duration_ms() is None and jf.get_last_gpu_duration_ms() is None


def test_interpolator_timing_never_breaks_the_caller(monkeypatch):
    a, b = _frames(1)
    fi = pc.WgpuFrameInterpolator(mode="blend", device="cpu")
    fi.interpolate_py(a.tobytes(), b.tobytes(), W, H)

    def broken(*args, **kwargs):
        raise RuntimeError("no timer")

    monkeypatch.setattr(P, "calibrated_step_ms", broken)
    monkeypatch.setattr(P, "stage_timings_ms", broken)
    assert fi.get_last_gpu_duration_ms() == fi._last_wall_ms
    assert fi.get_last_gpu_duration_detail() == {"wall_ms": fi._last_wall_ms}


@pytest.mark.parametrize("mode", ["blend", "flow", "flow_exact"])
def test_interpolator_array_methods_match_jax(mode):
    a, b = _frames(2, 48, 256)
    a = np.ascontiguousarray(np.roll(a, 5, axis=0))
    port = pc.WgpuFrameInterpolator(mode=mode, device="cpu")
    core = nsc.WgpuFrameInterpolator(mode=mode)
    mid = port.interpolate(a, b, 0.5)
    assert isinstance(mid, torch.Tensor) and mid.device == port.device
    d = np.abs(mid.numpy().astype(int) - np.asarray(core.interpolate(a, b, 0.5)).astype(int))
    assert d.max() <= 1
    pyr, jpyr = port.build_pyramid(a, 3), core.build_pyramid(a, 3)
    assert [tuple(p.shape) for p in pyr] == [p.shape for p in jpyr]
    assert max(float(np.abs(p.numpy() - np.asarray(q)).max()) for p, q in zip(pyr, jpyr)) <= 1e-6
    coarse = port.compute_coarse_flow(a, b, iters=8)
    assert coarse.device == port.device and tuple(coarse.shape) == (48, 256, 2)
    assert float(np.abs(coarse.numpy() - np.asarray(core.compute_coarse_flow(a, b, iters=8))).max()) <= 1e-5
    full = port.refine_flow_hierarchy(a, b, levels=3)
    assert float(np.abs(full.numpy() - np.asarray(core.refine_flow_hierarchy(a, b, levels=3))).max()) <= 1e-3
