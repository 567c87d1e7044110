"""The yardstick's counts on known shapes, and the readers that divide them by
traced time."""

from __future__ import annotations

import pytest

from portbench import registry, yardstick

BLEND = registry.config("lanczos3_blend_x2")
LEARNED = registry.config("esrgan_tpu4b2_x2_int8")
H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_by_kind():
    assert yardstick.peaks(H100) == {"hbm_bytes_s": 3.35e12, "int8_ops_s": 1979e12}
    assert yardstick.peaks("NVIDIA H100 PCIe")["hbm_bytes_s"] == 2.0e12
    assert yardstick.peaks("cpu") == yardstick.peaks(H100)


def test_resample_blend_bytes():
    # 1080p frame + prev_up read, cur_up + mid written: 107.8 MB, 0.0322 ms
    assert yardstick.resample_blend_bytes(BLEND) == 1920 * 1080 * 4 + 3 * 3840 * 2160 * 4
    assert yardstick.resample_blend_bytes(BLEND) / 3.35e12 == pytest.approx(3.218e-5, rel=1e-3)
    three = {**BLEND, "time_t": [1 / 3, 2 / 3]}
    assert yardstick.resample_blend_bytes(three) - yardstick.resample_blend_bytes(BLEND) == 3840 * 2160 * 4


def test_esrgan_convs_at_real_widths():
    convs = yardstick.esrgan_convs(LEARNED)
    assert [c[0] for c in convs] == ["head", "block0/conv1", "block0/conv2", "block1/conv1",
                                     "block1/conv2", "trunk", "tail", "base"]
    assert [(ci, co) for _, ci, co in convs] == [(48, 128)] + [(128, 128)] * 5 + [(128, 192), (48, 192)]
    assert yardstick.conv_positions(LEARNED) == 270 * 480
    ops = yardstick.esrgan_ops_per_frame(LEARNED)
    assert ops == 18 * 270 * 480 * (48 * 128 + 5 * 128 * 128 + 128 * 192 + 48 * 192)
    assert ops == pytest.approx(0.2843e12, rel=1e-3)


def test_conv_q_bound():
    pos = 270 * 480
    block = max(yardstick.conv_ops(pos, 128, 128) / 1979e12, yardstick.conv_q_bytes(pos, 128, 128) / 3.35e12)
    assert yardstick.conv_q_bytes(pos, 128, 128) == pos * 128 * 3 + 9 * 128 * 128 + 8 * 128
    assert block == pytest.approx(2 * 9 * 128 * 128 * pos / 1979e12)  # operations bound it
    total = yardstick.conv_q_bound_s(LEARNED, H100)
    assert 5 * block < total < 8 * block
    # head and base are bound by their bytes, the rest by their operations
    assert total == pytest.approx(1.5405e-4, rel=1e-3)


def record(ops, frames_in=10, frames_out=10, window_us=1e5, busy_us=5e4):
    return {"ops": ops, "frames_in": frames_in, "frames_out": frames_out, "window_us": window_us,
            "busy_us": busy_us, "breakdown": {}}


def op(name, dur, cat="kernel", ranges=()):
    return {"name": name, "cat": cat, "ts": 0.0, "dur": dur, "ranges": list(ranges)}


QNAME = "void (anonymous namespace)::conv3x3_kernel<16, 16, 4, false, 2>(x)"


def test_conv3x3_q_roofline_reader():
    read = registry.per_layer_reader("kernels.conv3x3_q_roofline")
    bound_us = yardstick.conv_q_bound_s(LEARNED, H100) * 1e6
    launches = [op(QNAME, bound_us / 8 * 5)] * 80  # 10 frames, 5x their bound
    ctx = {"record": record(launches), "cfg": LEARNED, "kind": H100}
    assert read(ctx) == pytest.approx(20.0)
    bf16 = [op(QNAME.replace(", 2>", ", 1>"), 1.0)] * 80
    assert read({**ctx, "record": record(bf16)}) is None  # no int8-grid launch
    assert read({**ctx, "record": record(launches[:79])}) is None  # not one per conv per frame
    assert read({**ctx, "cfg": BLEND}) is None


def test_resample_fused_roofline_reader():
    read = registry.per_layer_reader("kernels.resample_fused_roofline")
    bound_us = yardstick.resample_blend_bytes(BLEND) / 3.35e12 * 1e6
    ctx = {"record": record([op("resample_fused_kernel(...)", 4 * bound_us)] * 3), "cfg": BLEND, "kind": H100}
    assert read(ctx) == pytest.approx(25.0)
    assert read({**ctx, "record": record([op("other", 1.0)])}) is None


def test_learned_mfu_reader():
    read = registry.per_layer_reader("learned_mfu")
    # 200 frames in 1 s
    ctx = {"record": record([], frames_in=200, frames_out=200, window_us=1e6), "cfg": LEARNED, "kind": H100}
    assert read(ctx) == pytest.approx(100 * yardstick.esrgan_ops_per_frame(LEARNED) * 200 / 1979e12)
    assert read(ctx) == pytest.approx(2.873, rel=1e-3)
    assert read({**ctx, "cfg": BLEND}) is None


def test_per_frame_device_time_readers():
    ops = [op("Memcpy HtoD (Pageable -> Device)", 300.0, "gpu_memcpy"),
           op("Memcpy DtoH (Device -> Pageable)", 900.0, "gpu_memcpy"),
           op("k", 200.0, ranges=["portbench.models.learned"]),
           op("k", 100.0, ranges=["portbench.ops.color.ingest"]),
           op("k", 50.0, ranges=["portbench.ops.color.deliver"]),
           op("resample_fused_kernel", 150.0, ranges=["portbench.ops.blend_step"])]
    ctx = {"record": record(ops, frames_in=2), "cfg": LEARNED, "kind": H100}
    want = {"runtime.h2d_ms": 0.15, "runtime.d2h_ms": 0.45, "models.learned_ms": 0.1,
            "ops.color_ms": 0.075, "ops.blend_step_ms": 0.075, "models.learned_launches": 0.5,
            "device.idle_pct": 50.0}
    for name, value in want.items():
        assert registry.per_layer_reader(name)(ctx) == pytest.approx(value), name
    empty = {**ctx, "record": record([])}
    for name in want:
        if name != "device.idle_pct":
            assert registry.per_layer_reader(name)(empty) is None, name
