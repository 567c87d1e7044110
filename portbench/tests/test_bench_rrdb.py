"""The RRDBNet cell's parts on the CPU: the yardstick's count, the per-layer
readers on a synthetic record, the set-up's pin on what serves, and the
benchmark's reference against the program's plain path at a tiny size."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import registry, yardstick_rrdb
from portbench.reference import rrdbnet as bref

CFG = registry.config("realesrgan_x2plus_fp16")
TINY = {**CFG, "in_h": 16, "in_w": 24, "out_h": 32, "out_w": 48}
H100 = "NVIDIA H100 80GB HBM3"
UNDER = ["portbench.models.rrdb"]
CONV = "sm90_xmma_fprop_implicit_gemm_f16f16_f16f32_f32_nhwckrsc_nhwc_tilesize256x64x32"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<OpaqueType<2u>>"
ADD = "void at::native::elementwise_kernel<128, 4, CUDAFunctor_add<c10::Half>>"


def test_count_at_1080p_to_4k():
    assert yardstick_rrdb.macs_per_frame(CFG) == 9_295_965_388_800
    assert yardstick_rrdb.ops_per_frame(CFG) == 2 * 9_295_965_388_800
    convs = yardstick_rrdb.convs(CFG)
    assert len(convs) == 351
    assert sum(9 * ci * co + co for _, ci, co, _ in convs) == CFG["parameters"] == 16_703_171
    body = sum(9 * ci * co * p for n, ci, co, p in convs if n.startswith("body.") or n == "conv_body")
    assert body / yardstick_rrdb.macs_per_frame(CFG) == pytest.approx(0.924, abs=1e-3)
    assert yardstick_rrdb.fp16_peak(H100) == 989e12 and yardstick_rrdb.fp16_peak("cpu") == 989e12
    assert [(c[1], c[2]) for c in convs[1:6]] == [(64, 32), (96, 32), (128, 32), (160, 32), (192, 64)]


def record(ops, frames_in=4, frames_out=4, window_us=8e5):
    return {"ops": ops, "frames_in": frames_in, "frames_out": frames_out, "window_us": window_us,
            "busy_us": window_us, "breakdown": {}}


def op(name, dur, cat="kernel", ranges=UNDER):
    return {"name": name, "cat": cat, "ts": 0.0, "dur": dur, "ranges": list(ranges)}


def read(name, rec, cfg=CFG):
    return registry.per_layer_reader(name)({"record": rec, "cfg": cfg, "kind": H100})


def test_readers_on_a_synthetic_record():
    # 4 frames: 100 ms of convs, 60 ms of glue a frame; one op outside the model
    ops = [op(CONV, 100e3), op(CAT, 40e3), op(ADD, 15e3), op("Memset (Device)", 5e3, "gpu_memset")] * 4
    ops.append(op(CONV, 1e6, ranges=["portbench.ops.color.ingest"]))
    rec = record(ops)
    assert read("models.rrdb_ms", rec) == pytest.approx(160.0)
    assert read("models.rrdb_glue_ms", rec) == pytest.approx(60.0)
    assert read("models.rrdb_launches", rec) == 4
    roof = read("kernels.rrdb_conv_roofline", rec)
    assert roof == pytest.approx(100 * 18.59e12 / 0.1 / 989e12, rel=1e-3) and 0 < roof <= 100
    mfu = read("rrdb_mfu", rec)
    assert mfu == pytest.approx(100 * 18.59e12 * 5 / 989e12, rel=1e-3) and 0 < mfu <= 100
    assert mfu < roof


def test_readers_are_silent_elsewhere():
    other = record([op(CONV, 100.0, ranges=["portbench.models.learned"])])
    for name in ("models.rrdb_ms", "models.rrdb_glue_ms", "models.rrdb_launches", "kernels.rrdb_conv_roofline"):
        assert read(name, other) is None, name
    learned = registry.config("esrgan_tpu4b2_x2_int8")
    assert read("rrdb_mfu", record([]), learned) is None
    assert read("kernels.rrdb_conv_roofline", record([op(CONV, 1.0)]), learned) is None


def test_setup_pins_what_serves(tmp_path, monkeypatch):
    system = registry.system("rrdb")
    assert "upscale_fn" in system.build(TINY, torch.device("cpu"), tmp_path / "ok")
    with pytest.raises(RuntimeError, match="sha256"):
        system.build({**TINY, "sha256": "0" * 64}, torch.device("cpu"), tmp_path / "sha")
    # a tree without the ladder serves its default one in its place, as the parent commit does
    el = importlib.import_module("nu_scaler_tpu_torch.models.esrgan_lite")
    make = el.make_pretrained_upscaler
    monkeypatch.setattr(el, "make_pretrained_upscaler",
                        lambda h, w, oh, ow, prefer="quality", device=None, trunk_impl="layers":
                        make(h, w, oh, ow, "quality", device, trunk_impl))
    with pytest.raises(RuntimeError, match="tpu4b2"):
        system.build(TINY, torch.device("cpu"), tmp_path / "parent")


def test_reference_against_the_program(tmp_path):
    from nu_scaler_tpu_torch.models import rrdbnet

    state = bref.seeded_state(TINY)
    bref.write_checkpoint(state, tmp_path, TINY)
    model = rrdbnet._load(tmp_path, TINY["step"], TINY["sha256"], 2)[0]
    g = torch.Generator().manual_seed(5)
    img = torch.randint(0, 256, (16, 24, 4), generator=g, dtype=torch.uint8)
    img[..., 3] = 255
    want = bref.Reference(TINY, torch.device("cpu")).upscale(img)
    for dtype, most in ((torch.float32, 1), (torch.float16, 2)):
        got = rrdbnet.RRDBServing(model, 16, 24, 32, 48, "cpu", dtype)(img[None])[0]
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert int(d.max()) <= most, dtype
        assert float(d.bool().float().mean()) < (0.001 if dtype == torch.float32 else 0.15), dtype
    control = bref.Reference(TINY, torch.device("cpu"), control=True).upscale(img)
    assert float((control != want).float().mean()) > 0.15
    with pytest.raises(ValueError, match="sha256"):
        bref.Reference({**TINY, "sha256": "0" * 64}, torch.device("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("fault", bref.FAULTS)
def test_planted_fault_fails_the_cell_at_full_size(card, fault):
    """Each planted fault, in fp16 in the program's place, fails the cell's
    limits on the card."""
    import time

    from portbench.run import run_cell, set_cache_dirs

    set_cache_dirs()
    bench = registry.benchmark()
    cell = registry.cell(bench, "realesrgan_x2_yuv420")
    mix = registry.traffic(cell["traffic"])

    def fns(cfg, device, scratch):
        out = {"upscale_fn": bref.Reference(cfg, device, fault=fault).graph}
        out.update(registry.link(mix["link"]).program(cfg, device))
        return out

    r = run_cell(cell, 2**31 + 211, 1.0, False, card, time.perf_counter(), step_fns=fns, bench=bench)
    assert r["failed"] == 0 and r["compared_frames"] > 0
    assert not r["correct"], (fault, r["compared"])
