"""The port's spans (`nu_scaler_tpu_torch.utils.tracing`) on the CPU at
64×128: off by default and then inert, the runtime's spans nested as the
pipeline runs them with each fetch's frame and bytes, the learned graph's
stages, the set-up spans, and the shared clock with `torch.profiler`.

Times here are the host's: the tests check structure (names, nesting,
frames, bytes, counts), never speed.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nu_scaler_tpu_torch.kernels import _build
from nu_scaler_tpu_torch.kernels import conv_cuda as cc
from nu_scaler_tpu_torch.models import esrgan_lite as pel
from nu_scaler_tpu_torch.ops import color
from nu_scaler_tpu_torch.ops.resample import make_fused_blend
from nu_scaler_tpu_torch.runtime.streaming import LivePipeline
from nu_scaler_tpu_torch.utils import tracing

H, W = 64, 128
DEPTH = 2
FRAMES = 6
STAGES = ("s2d", "head", "blocks", "trunk", "tail", "base", "assemble")


@pytest.fixture
def traced():
    """Tracing on for the test's body; off and emptied after it."""
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.drain()


def _inputs(link: str, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    if link == "rgba":
        return [rng.integers(0, 256, (H, W, 4), np.uint8) for _ in range(FRAMES)]
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    return [tuple(rng.integers(0, 256, s, np.uint8) for s in shapes) for _ in range(FRAMES)]


def _pipeline(link: str) -> LivePipeline:
    """The live 2× blend step on the CPU; over the 4:2:0 link with its
    converters, as a transcode runs it."""
    step = make_fused_blend(H, W, 2 * H, 2 * W, "lanczos3", 0.5, "cpu")
    if link == "rgba":
        return LivePipeline(None, device="cpu", depth=DEPTH, fused_step_fn=step)
    return LivePipeline(None, device="cpu", depth=DEPTH, fused_step_fn=step,
                        ingest_fn=color.make_yuv420_to_rgba(H, W, "cpu"),
                        deliver_fn=color.make_delivery_fn(2 * H, 2 * W, "yuv420", 0, "cpu"))


def _run(link: str) -> list:
    pipe = _pipeline(link)
    return [pipe.put(f) for f in _inputs(link)]


def _children(spans: list, parent: dict) -> list:
    return [s for s in spans if s["parent"] == parent["id"]]


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)


def test_tracing_off_is_inert():
    """Off (the default): a site gets the shared no-op span, the pipeline
    records nothing, and a profiler session sees no ``nu.`` range."""
    assert tracing.on is False
    assert tracing.span("nu.x") is tracing.OFF and tracing.span("nu.y", frame=3) is tracing.OFF
    with tracing.span("nu.x") as s:
        s.set(bytes=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run("yuv420")
    assert not [e for e in prof.events() if e.name.startswith("nu.")]
    drained = tracing.drain()
    assert drained["spans"] == [] and drained["dropped"] == 0


@pytest.mark.parametrize("link", ["rgba", "yuv420"])
def test_put_returns_the_same_bytes_traced(link):
    """`put` hands back byte-equal payloads with tracing on and off."""
    off = _run(link)
    tracing.enable()
    try:
        on = _run(link)
    finally:
        tracing.disable()
        assert tracing.drain()["spans"]
    assert [len(o) for o in off] == [len(o) for o in on] == [0, 0, 1, 2, 2, 2]
    assert all(_same(a, b) for x, y in zip(off, on) for a, b in zip(x, y))


@pytest.mark.parametrize("link", ["rgba", "yuv420"])
def test_runtime_spans_nest_as_the_pipeline_runs(traced, link):
    """One ``nu.runtime.put`` a frame, its upload, step, deliver and fetch
    under it; the fetch of frame i - depth with the payloads' bytes and its
    three parts; the ops' spans under the step and the put."""
    inputs = _inputs(link)
    pipe = _pipeline(link)
    outs = [pipe.put(f) for f in inputs]
    spans = traced.drain()["spans"]
    puts = sorted((s for s in spans if s["name"] == "nu.runtime.put"), key=lambda s: s["start_ns"])
    assert [p["frame"] for p in puts] == list(range(FRAMES))
    assert all(p["parent"] is None for p in puts)
    for i, (put, out) in enumerate(zip(puts, outs)):
        kids = _children(spans, put)
        names = [k["name"] for k in sorted(kids, key=lambda k: k["start_ns"])]
        want = ["nu.runtime.upload", "nu.runtime.step"]
        if link == "yuv420":
            want = ["nu.runtime.upload", "nu.ops.color.ingest", "nu.runtime.step", "nu.runtime.deliver"]
        assert names == want + (["nu.runtime.fetch"] if i >= DEPTH else [])
        upload = next(k for k in kids if k["name"] == "nu.runtime.upload")
        assert upload["bytes"] == tracing.nbytes(inputs[i]) and upload["frame"] == i
        step = next(k for k in kids if k["name"] == "nu.runtime.step")
        assert [c["name"] for c in _children(spans, step)] == ["nu.ops.blend_step"]
        assert all(c["frame"] == i for c in _children(spans, step))
        if i < DEPTH:
            continue
        fetch = next(k for k in kids if k["name"] == "nu.runtime.fetch")
        assert fetch["frame"] == i - DEPTH
        assert fetch["bytes"] == sum(tracing.nbytes(p) for p in out) > 0
        parts = sorted(_children(spans, fetch), key=lambda k: k["start_ns"])
        assert [p["name"] for p in parts] == ["nu.runtime.fetch.wait_own", "nu.runtime.fetch.wait_behind",
                                              "nu.runtime.fetch.copy"]
        assert all(p["frame"] == i - DEPTH for p in parts)
        assert put["start_ns"] <= fetch["start_ns"] <= fetch["end_ns"] <= put["end_ns"]


def test_put_device_spans_its_put_without_a_fetch(traced):
    pipe = _pipeline("rgba")
    for f in _inputs("rgba"):
        pipe.put_device(f)
    spans = traced.drain()["spans"]
    assert sum(s["name"] == "nu.runtime.put" for s in spans) == FRAMES
    assert not [s for s in spans if s["name"].startswith("nu.runtime.fetch")]


def _int8_serving(conv_q=cc.conv3x3_q_plain) -> pel.FusedServing:
    model, _ = pel.load_model("tpu4b2", 2)
    return pel.FusedServing(model, H, W, "cpu", quant_scales=pel.load_act_scales("tpu4b2", 2),
                            conv_q=conv_q)


def test_int8_graph_spans_its_seven_stages(traced):
    """`FusedServing` int8 on the conv's plain version: ``nu.models.learned``
    a call, its seven stages under it once each, in order; the convs run
    under head, blocks, trunk, tail and base."""
    calls = []

    def conv_q(*args):
        calls.append(traced._stack()[-1].name)
        return cc.conv3x3_q_plain(*args)

    fs = _int8_serving(conv_q)
    traced.drain()
    fs(torch.zeros((1, H, W, 4), dtype=torch.uint8))
    spans = traced.drain()["spans"]
    (top,) = [s for s in spans if s["name"] == "nu.models.learned"]
    kids = sorted(_children(spans, top), key=lambda k: k["start_ns"])
    assert [k["name"] for k in kids] == [f"nu.models.learned.{s}" for s in STAGES]
    assert len(spans) == 1 + len(STAGES)
    assert calls == ["nu.models.learned." + s for s in
                     ("head", "blocks", "blocks", "blocks", "blocks", "trunk", "tail", "base")]


def test_bf16_graph_spans_its_stages(traced):
    model, _ = pel.load_model("tpu4b2", 2)
    fs = pel.FusedServing(model, H, W, "cpu", conv=cc.conv3x3_plain)
    traced.drain()
    fs(torch.zeros((1, H, W, 4), dtype=torch.uint8))
    spans = traced.drain()["spans"]
    (top,) = [s for s in spans if s["name"] == "nu.models.learned"]
    assert [k["name"] for k in sorted(_children(spans, top), key=lambda k: k["start_ns"])] == [
        f"nu.models.learned.{s}" for s in ("s2d", "layers", "base", "assemble")]


def test_weights_set_up_is_spanned(traced):
    """Loading the weights (`_cached_model`, bypassing its cache) and
    putting them on the device (`FusedServing.__init__`): one
    ``nu.setup.weights`` each."""
    assert pel._cached_model.__wrapped__("tpu4b2", 2) is not None
    _int8_serving()
    names = [s["name"] for s in traced.drain()["spans"]]
    assert names == ["nu.setup.weights", "nu.setup.weights"]


def test_kernel_set_up_span_says_whether_it_compiled(traced, monkeypatch, tmp_path):
    """``nu.setup.kernels``: `compiled` true exactly when the compiler ran."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    ran = []
    real = _build._compile

    def compile_(compiler, name):
        ran.append(name)
        return real(compiler, name)

    monkeypatch.setattr(_build, "_compile", compile_)
    load = _build.load_library.__wrapped__  # past the process's cache
    load("framering")
    load("framering")
    spans = traced.drain()["spans"]
    assert ran == ["framering"]
    assert [(s["name"], s["library"], s["compiled"]) for s in spans] == [
        ("nu.setup.kernels", "framering", True), ("nu.setup.kernels", "framering", False)]


def test_spans_share_the_profilers_clock(traced, tmp_path):
    """Under a CPU `torch.profiler` each span is a ``user_annotation`` of its
    name; laid over the trace through the anchor and
    ``baseTimeNanoseconds`` its in-memory copy starts within 1 ms of it."""
    pipe = _pipeline("yuv420")
    inputs = _inputs("yuv420")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in inputs:
            pipe.put(f)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    drained = traced.drain()
    anchor = drained["anchor"]
    spans = drained["spans"]
    marks = [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("nu.")]
    assert sorted(e["name"] for e in marks) == sorted(s["name"] for s in spans)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    for name in {s["name"] for s in spans}:
        mine = sorted((s["start_ns"] - anchor["perf_counter_ns"] + anchor["time_ns"]) / 1e3
                      for s in spans if s["name"] == name)
        theirs = sorted(e["ts"] + base_us for e in marks if e["name"] == name)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1000.0, name


def test_a_full_buffer_drops_and_counts(traced):
    traced.enable(capacity=3)
    for _ in range(5):
        with traced.span("nu.x"):
            pass
    drained = traced.drain()
    assert len(drained["spans"]) == 3 and drained["dropped"] == 2
    assert traced.drain() == {"spans": [], "dropped": 0, "anchor": drained["anchor"]}


def test_disable_keeps_what_was_recorded_and_enable_starts_afresh(traced):
    with traced.span("nu.a", frame=4, bytes=(np.zeros(3, np.uint8), torch.zeros(2, dtype=torch.int16))) as s:
        s.set(extra="x")
        with traced.span("nu.b"):
            pass
    traced.disable()
    with traced.span("nu.c"):
        pass
    spans = traced.drain()["spans"]
    assert [(s["name"], s["frame"], s["bytes"]) for s in spans] == [("nu.b", 4, None), ("nu.a", 4, 7)]
    assert spans[0]["parent"] == spans[1]["id"] and spans[1]["extra"] == "x"
    traced.enable()
    with traced.span("nu.d"):
        pass
    traced.enable()
    assert traced.drain()["spans"] == []


def test_each_thread_has_its_own_parents(traced):
    """A span opened on another thread is no child of this thread's span."""
    def work():
        with traced.span("nu.worker"):
            pass

    with traced.span("nu.main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = {s["name"]: s for s in traced.drain()["spans"]}
    assert spans["nu.worker"]["parent"] is None and spans["nu.main"]["parent"] is None


def test_nbytes_of_payloads():
    y = np.zeros((4, 6), np.uint8)
    assert tracing.nbytes(y) == 24
    assert tracing.nbytes((y, y[:2, :3], y[:2, :3])) == 36
    assert tracing.nbytes([torch.zeros(3, dtype=torch.float32), (y,)]) == 36
    assert tracing.nbytes(b"abcd") == 4
