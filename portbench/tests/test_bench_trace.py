"""The reduction of a chrome trace: busy and idle time inside the window,
device operations attributed to the benchmark's ranges through the runtime
call that launched them, and the breakdown."""

from __future__ import annotations

import json

import pytest

from portbench import registry, trace


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic() -> list[dict]:
    """A 1000 us window: two steps, each an upload, a kernel under the blend
    range and a fetch; the device busy 100 + 150 + 200 + 100 + 150 + 200 us,
    one kernel launched before the window."""
    events = [ev("portbench.window", "user_annotation", 0, 1000),
              ev("early", "kernel", -50, 40, tid=7, corr=99)]
    for s, t0 in enumerate((0, 500)):
        c = 10 * s
        events += [
            ev("aten::copy_", "cpu_op", t0 + 5, 120),
            ev("cudaMemcpyAsync", "cuda_runtime", t0 + 10, 5, corr=c + 1),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t0 + 20, 100, tid=7, corr=c + 1),
            ev("portbench.ops.blend_step", "user_annotation", t0 + 130, 20),
            ev("cudaLaunchKernel", "cuda_runtime", t0 + 135, 5, corr=c + 2),
            ev("resample_fused_kernel", "kernel", t0 + 140, 150, tid=7, corr=c + 2),
            ev("cudaMemcpyAsync", "cuda_runtime", t0 + 200, 100, corr=c + 3),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t0 + 290, 200, tid=7, corr=c + 3),
        ]
    return events


def test_busy_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40)]
    assert trace.busy_us(spans, 0, 50) == 30
    assert trace.busy_us(spans, 8, 35) == 17
    assert trace.idle_gaps(spans, 0, 50) == [(20, 30), (40, 50)]
    assert trace.idle_gaps([], 0, 5) == [(0, 5)]


def test_reduce_synthetic_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic()}))
    r = trace.reduce(trace.load_events(path), frames_in=2, frames_out=4)
    assert r["window_us"] == 1000
    assert r["busy_us"] == 900  # 2 x (100 + 150 + 200): the early kernel is outside
    assert len(r["ops"]) == 6
    blend = trace.select(r, ("kernel",), under="portbench.ops.blend_step")
    assert [o["name"] for o in blend] == ["resample_fused_kernel"] * 2
    assert trace.device_us(r, ("gpu_memcpy",), name_has="DtoH") == 400
    ctx = {"record": r}
    assert registry.per_layer_reader("device.idle_pct")(ctx) == pytest.approx(10.0)
    assert registry.per_layer_reader("ops.blend_step_ms")(ctx) == pytest.approx(0.15)
    assert registry.per_layer_reader("runtime.h2d_ms")(ctx) == pytest.approx(0.1)
    device_ops = dict(r["breakdown"]["device_ops"])
    assert device_ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(400e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # each gap is named by the innermost host call over its middle
    assert gaps == pytest.approx({"cudaMemcpyAsync": 20e-6,  # [0, 20]: the first upload's call
                                  "portbench.ops.blend_step": 40e-6,  # [120, 140], [620, 640]
                                  "aten::copy_": 30e-6,  # [490, 520]: the second upload
                                  "host outside any traced call": 10e-6})  # [990, 1000]


def test_a_trace_without_the_window_raises():
    with pytest.raises(ValueError):
        trace.reduce([ev("k", "kernel", 0, 1)], 1, 1)
