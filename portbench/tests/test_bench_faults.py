"""A whole run of each cell at a tiny size on the CPU (everything but the look
for a card): `correct` holds for the program, and comes out false with the
timed path broken underneath, and for the control in the program's place."""

from __future__ import annotations

import pytest
import torch

from portbench import registry
from portbench.control import control_fns

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
TAIL_CELLS = next(m["workloads"] for m in registry.benchmark()["per_layer"]
                  if m["name"] == "runtime.frame_latency_p95_ms")


def program_fns(cell_name: str, fault):
    """`run_cell`'s `step_fns`: the program's step and link functions, with
    `fault` applied to the step."""
    w = registry.cell(registry.benchmark(), cell_name)
    mix = registry.traffic(w["traffic"])

    def fns(cfg, device, scratch):
        out = registry.system(cfg["system"]).build(cfg, device, scratch)
        key = "fused_step_fn" if "fused_step_fn" in out else "upscale_fn"
        out[key] = fault(out[key])
        out.update(registry.link(mix["link"]).program(cfg, device))
        return out

    return fns


def stale(fn):
    """A step that returns its state unchanged: the first call's outputs,
    every call."""
    first = []

    def step(*args):
        if not first:
            first.append(fn(*args))
        return first[0]

    return step


def altered(fn):
    """An answer altered where it is produced: a block of every output
    inverted."""

    def flip(t):
        t = t.clone()
        t[:4, :4, :3] = 255 - t[:4, :4, :3]
        return t

    def step(*args):
        out = fn(*args)
        return tuple(flip(t) for t in out) if isinstance(out, tuple) else flip(out)

    return step


def half_left_out(fn):
    """Half of the work left out: the cross-fade's mids dropped, or the lower
    half of each upscale's rows never written."""

    def step(*args):
        out = fn(*args)
        if isinstance(out, tuple):
            return out[:1]
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out

    return step


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = tiny(cell, seed=2**31 + 17, seconds=1.5)  # long enough for six frames on a busy CPU
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0 and r["compared_frames"] == 6
    bench = registry.benchmark()
    assert set(r["metrics"]) == {m["name"] for m in registry.metrics_of(bench, "end_to_end", cell)}
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, altered, half_left_out])
def test_broken_timed_path_is_not_correct(tiny, cell, fault):
    r = tiny(cell, step_fns=program_fns(cell, fault))
    assert not r["correct"], (fault.__name__, r["compared"], r["failed"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    w = registry.cell(registry.benchmark(), cell)
    r = tiny(cell, step_fns=control_fns(registry.traffic(w["traffic"])))
    assert r["failed"] == 0
    assert not r["correct"], r["compared"]


def test_traced_run_reports_per_layer_metrics(tiny):
    r = tiny("blend_x2_yuv420", trace=True)
    assert r["correct"]
    assert "device.idle_pct" in r["metrics"] and "output_fps" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", TAIL_CELLS)
def test_traced_run_reads_the_tail_after_the_trace(tiny, cell):
    r = tiny(cell, trace=True, seconds=0.5)
    assert r["correct"] and r["metrics"]["runtime.frame_latency_p95_ms"]["value"] > 0
    assert r["latency_frames"] > 4  # frames put after the four traced steps came back


def test_no_card_no_result(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("key, value", [("sha256", "0" * 64), ("step", 1), ("arch", "tpu4")])
def test_learned_setup_fails_unless_the_configured_checkpoint_serves(tmp_path, key, value):
    cfg = {**registry.config("esrgan_tpu4b2_x2_int8"), "in_h": 64, "in_w": 128, "out_h": 128,
           "out_w": 256}
    system = registry.system("learned")
    assert "upscale_fn" in system.build(cfg, torch.device("cpu"), tmp_path / "ok")
    with pytest.raises(RuntimeError):
        system.build({**cfg, key: value}, torch.device("cpu"), tmp_path / "pinned")
