"""The readings of the program's own spans (`portbench/program_trace.py`): the
device trace with ``nu.`` ranges reduced, each reader on synthetic records
with its None cases, the existing readers unmoved by ``nu.`` ranges in a
trace, the harness's traced run with the tracer off throughout, and one
measurement at a tiny size on the CPU."""

from __future__ import annotations

import itertools
import time

import pytest
import torch

from nu_scaler_tpu_torch.models import esrgan_lite as pel
from nu_scaler_tpu_torch.runtime.streaming import LivePipeline
from nu_scaler_tpu_torch.utils import tracing
from portbench import program_trace as pt
from portbench import registry, trace
from portbench.tests.conftest import TINY, tiny_run
from portbench.tests.test_bench_trace import ev, synthetic

STEP_RANGES = (  # (name, start, end) after each step's t0 in `synthetic()`
    ("nu.runtime.put", 1, 495), ("nu.runtime.upload", 3, 126), ("nu.runtime.step", 127, 160),
    ("nu.runtime.fetch", 190, 494), ("nu.runtime.fetch.wait_behind", 191, 198),
    ("nu.runtime.fetch.copy", 199, 493))


def with_nu_ranges(events: list) -> list:
    out = list(events)
    for t0 in (0, 500):
        out += [ev(n, "user_annotation", t0 + a, b - a) for n, a, b in STEP_RANGES]
    return out


def test_reduce_program_labels_ops_and_idle_time():
    r = pt.reduce_program(with_nu_ranges(synthetic()), 2)
    assert r["window_us"] == 1000 and r["busy_us"] == 900
    paths = {o["name"]: o["path"] for o in r["ops"] if o["ts"] < 500}
    assert paths["Memcpy HtoD (Pageable -> Device)"] == ("nu.runtime.put", "nu.runtime.upload")
    assert paths["resample_fused_kernel"] == ("nu.runtime.put", "nu.runtime.step")
    assert paths["Memcpy DtoH (Device -> Pageable)"] == ("nu.runtime.put", "nu.runtime.fetch",
                                                         "nu.runtime.fetch.copy")
    # the gaps [0, 20], [120, 140], [490, 520], [620, 640], [990, 1000] cut by the ranges
    assert r["idle_by_span"] == pytest.approx({
        pt.OUTSIDE: 1 + 6 + 5, "nu.runtime.put": 2 + 1 + 1 + 2 + 1 + 1,
        "nu.runtime.upload": 17 + 6 + 17 + 6, "nu.runtime.step": 13 + 13,
        "nu.runtime.fetch.copy": 3 + 3, "nu.runtime.fetch": 1 + 1})
    program = {"record": r, "dropped": 0}
    assert pt.READERS["device.idle_fetch_pct"](program) == pytest.approx(0.8)
    assert pt.READERS["device.idle_outside_pct"](program) == pytest.approx(1.2)
    assert pt.READERS["device.idle_fetch_pct"]({**program, "dropped": 1}) is None
    plain = {"record": pt.reduce_program(synthetic(), 2), "dropped": 0}
    assert pt.READERS["device.idle_fetch_pct"](plain) is None  # no nu. range: nothing to read


def test_existing_readers_ignore_the_programs_ranges():
    """Every existing per-layer reader of the trace reads the same with the
    program's ``nu.`` ranges in it."""
    cfg = registry.config("lanczos3_blend_x2")
    names = [m["name"] for m in registry.benchmark()["per_layer"] if m["source"] == "device_trace"]
    got = []
    for events in (synthetic(), with_nu_ranges(synthetic())):
        r = trace.reduce(events, 2, 4)
        ctx = {"record": r, "cfg": cfg, "kind": "NVIDIA H100 80GB HBM3"}
        got.append({n: registry.per_layer_reader(n)(ctx) for n in names})
    assert got[0] == got[1]
    assert got[0]["runtime.d2h_ms"] == pytest.approx(0.2)


def learned_trace(stages=pt.STAGES, frames: int = 2) -> list:
    """A window of `frames` learned calls: per call a conv launched under
    each stage but s2d and assemble, and one elementwise kernel under
    each stage."""
    events = [ev("portbench.window", "user_annotation", 0, 1000 * frames)]
    corr = 0
    for f in range(frames):
        t0 = 1000 * f
        events.append(ev("nu.models.learned", "user_annotation", t0 + 10, 900))
        for k, stage in enumerate(stages):
            a = t0 + 20 + 100 * k
            events.append(ev(f"nu.models.learned.{stage}", "user_annotation", a, 90))
            kernels = ["elementwise_kernel"] + ([] if stage in ("s2d", "assemble") else ["conv3x3_kernel<2>"])
            for j, name in enumerate(kernels):
                corr += 1
                events.append(ev("cudaLaunchKernel", "cuda_runtime", a + 5 + 10 * j, 2, corr=corr))
                events.append(ev(name, "kernel", a + 40 + 20 * j, 10, tid=7, corr=corr))
    return events


def test_glue_reads_the_learned_stages():
    r = pt.reduce_program(learned_trace(), 2)
    program = {"record": r, "dropped": 0}
    assert pt.READERS["models.glue_launches"](program) == 7.0
    assert pt.READERS["models.glue_ms"](program) == pytest.approx(0.07)
    stages = pt.learned_stage_ms(r)
    assert stages["head.conv"] == pytest.approx(0.01) and stages["s2d"] == pytest.approx(0.01)
    assert "s2d.conv" not in stages


@pytest.mark.parametrize("stages", [pt.STAGES[:-1], pt.STAGES[1:], ()])
def test_glue_is_silent_without_every_stage(stages):
    program = {"record": pt.reduce_program(learned_trace(stages), 2), "dropped": 0}
    assert pt.READERS["models.glue_ms"](program) is None
    assert pt.READERS["models.glue_launches"](program) is None


def span(i, name, a, b, parent=None, **attrs):
    return {"name": name, "start_ns": int(a * 1e6), "end_ns": int(b * 1e6), "id": i, "parent": parent,
            "frame": None, "bytes": None, **attrs}


def host_program(puts: int = 100, slow: float = 20.0) -> dict:
    """`puts` puts of 10 ms: upload 1, fetch 6 (own 0.5, behind 2, copy 3,
    the last put's copy `slow`)."""
    spans, i = [], 0
    for p in range(puts):
        t, put = 100.0 * p, i + 1
        copy = slow if p == puts - 1 else 3.0
        spans += [span(put, "nu.runtime.put", t, t + 10 + copy - 3),
                  span(put + 1, "nu.runtime.upload", t, t + 1, put),
                  span(put + 2, "nu.runtime.fetch", t + 4, t + 10 + copy - 3, put),
                  span(put + 3, "nu.runtime.fetch.wait_own", t + 4, t + 4.5, put + 2),
                  span(put + 4, "nu.runtime.fetch.wait_behind", t + 5, t + 7, put + 2),
                  span(put + 5, "nu.runtime.fetch.copy", t + 7, t + 7 + copy, put + 2)]
        i += 6
    return {"spans": spans, "dropped": 0}


def test_host_readers_on_synthetic_spans():
    p = host_program()
    read = {n: pt.READERS[n](p) for n in pt.READERS}
    assert read["runtime.upload_host_ms"] == pytest.approx(1.0)
    assert read["runtime.launch_host_ms"] == pytest.approx(3.0)  # put - upload - fetch
    assert read["runtime.fetch_wait_own_ms"] == pytest.approx(0.5)
    assert read["runtime.fetch_wait_behind_ms"] == pytest.approx(2.0)
    assert read["runtime.fetch_copy_ms"] == pytest.approx(3.0)
    assert read["runtime.fetch_copy_p99_ms"] == pytest.approx(3.0)  # 1 slow copy in 100: p99 is the 99th
    assert pt.READERS["runtime.fetch_copy_p99_ms"](host_program(puts=50)) == pytest.approx(20.0)
    for name in ("models.glue_ms", "device.idle_fetch_pct", "setup.kernels_s"):
        assert read[name] is None
    own = pt.host_self_ms(p)
    assert own["nu.runtime.put"] == pytest.approx(3.0) and own["nu.runtime.fetch"] == pytest.approx(0.5)
    assert own["nu.runtime.fetch.copy"] == pytest.approx(3.17) and list(own)[0] == "nu.runtime.fetch.copy"
    assert pt.host_self_ms({"spans": [], "dropped": 0}) == {}


@pytest.mark.parametrize("program", [{"spans": [], "dropped": 0}, {**host_program(), "dropped": 3},
                                     {"spans": [span(1, "nu.other", 0, 1)], "dropped": 0}, {}])
def test_host_readers_are_silent_without_whole_spans(program):
    for name in [n for n in pt.READERS if n.startswith("runtime.")]:
        assert pt.READERS[name](program) is None


def test_setup_readers_count_outermost_spans():
    setup = [span(1, "nu.setup.kernels", 0, 300, library="conv3x3", compiled=True),
             span(2, "nu.setup.kernels", 400, 450, library="resample_fused", compiled=False),
             span(3, "nu.setup.weights", 500, 900), span(4, "nu.setup.weights", 600, 700, 3)]
    p = {"setup": setup, "setup_dropped": 0}
    assert pt.READERS["setup.kernels_s"](p) == pytest.approx(0.35)
    assert pt.READERS["setup.weights_s"](p) == pytest.approx(0.4)
    assert pt.READERS["setup.kernels_s"]({**p, "setup_dropped": 1}) is None
    assert pt.READERS["setup.weights_s"]({"setup": setup[:2], "setup_dropped": 0}) is None


def test_the_harness_runs_its_window_with_the_tracer_off(monkeypatch):
    """A `--trace 1` run of the harness: the profiler window and the
    untraced seconds after it, every put with the program's tracer off."""
    seen = []
    real = LivePipeline.put

    def put(self, frame):
        seen.append(tracing.on)
        return real(self, frame)

    monkeypatch.setattr(LivePipeline, "put", put)
    result = tiny_run("blend_x2_yuv420", trace=True)
    assert result["correct"] and len(seen) > 8 and not any(seen)
    assert not [o for o in result["breakdown"]["idle_gaps"] if o[0].startswith("nu.")]


@pytest.mark.parametrize("cell_name", ["blend_x2_yuv420", "dlss_x2_rgba"])
def test_measure_runs_tracer_off_then_on(monkeypatch, cell_name):
    """The program-traced run at 64x128 on the CPU: set-up spans caught, the
    window with the tracer on, then the seconds with it off and on in turns;
    the host readings read; nothing dropped."""
    seen = []
    real = LivePipeline.put

    def put(self, frame):
        seen.append(tracing.on)
        return real(self, frame)

    monkeypatch.setattr(LivePipeline, "put", put)
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = {**registry.config(cell["config"]), **TINY}
    mix = {**registry.traffic(cell["traffic"]), "warmup_steps": 4, "traced_steps": 4}
    if cell_name.startswith("dlss"):  # a fresh process's set-up: nothing loaded yet
        pel._build_pretrained.cache_clear()
        pel._cached_model.cache_clear()
    t0 = time.perf_counter()
    tracing.enable()
    try:
        out = pt.measure(cell, 11, 0.3, torch.device("cpu"), t0, cfg=cfg, mix=mix)
    finally:
        tracing.disable()
        tracing.drain()
    # warm-up (set-up) traced, the window traced, then the seconds off and on in turns
    runs = [(on, len(list(g))) for on, g in itertools.groupby(seen)]
    assert [on for on, _ in runs] == [True] + [False, True] * pt.ROUNDS and runs[0][1] == 4 + 4
    assert out["dropped"] == 0 and out["kernel_loads_in_window"] == []
    for name in ("runtime.upload_host_ms", "runtime.launch_host_ms", "runtime.fetch_wait_own_ms",
                 "runtime.fetch_wait_behind_ms", "runtime.fetch_copy_ms", "runtime.fetch_copy_p99_ms"):
        assert out["readings"][name] >= 0, name
    assert ("setup.weights_s" in out["readings"]) == cell_name.startswith("dlss")
    for side in ("off", "on"):
        assert len(out["tracer_cost"][side]["output_fps"]) == pt.ROUNDS
        assert min(out["tracer_cost"][side]["output_fps"]) > 0
    calls = out["program_breakdown"]["learned_calls"]
    assert calls == ([4, 4] if cell_name.startswith("dlss") else [0, 0])  # [calls, with all 7 stages]
    assert out["device"]["kind"] == "cpu"
