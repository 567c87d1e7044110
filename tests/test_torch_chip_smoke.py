"""The card check's helpers (`chip_smoke.py`) on the CPU: the bound every
kernel time is read against, the profiler trace's busy share, ptxas'
report, the work counts, the image metrics, the launch reader and the
guarded listing. The module's top level needs only numpy; these tests
run no kernel and touch no card."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

# ---------------------------------------------------------------------------
# the bound and the card's peaks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", sorted(cs.PEAKS))
def test_bound_is_bytes_when_bytes_take_longer(row):
    mem_bw, fp32 = cs.PEAKS[row]
    moved, ops = 3 * mem_bw / 1e3, fp32 / 1e3  # 3 ms of bytes, 1 ms of operations
    ms, by = cs.bound(moved, ops, mem_bw, fp32)
    assert by == "bytes" and ms == pytest.approx(3.0)


@pytest.mark.parametrize("row", sorted(cs.PEAKS))
def test_bound_is_operations_when_operations_take_longer(row):
    mem_bw, fp32 = cs.PEAKS[row]
    moved, ops = mem_bw / 1e3, 5 * fp32 / 1e3
    ms, by = cs.bound(moved, ops, mem_bw, fp32)
    assert by == "operations" and ms == pytest.approx(5.0)
    # the no-FMA instruction floor: the same helper at half the rate
    assert cs.bound(moved, ops, mem_bw, fp32 / 2) == (pytest.approx(10.0), "operations")


def test_bound_ties_go_to_bytes():
    assert cs.bound(2e9, 4e12, 2e12, 4e15) == (1.0, "bytes")


@pytest.mark.parametrize("kind, row", [("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
                                       ("NVIDIA H200", "H200"), ("NVIDIA A100-SXM4-80GB", "H100")])
def test_rates_of_reads_the_card_s_rows(kind, row):
    rates = cs.rates_of(kind)
    assert (rates.mem_bw, rates.fp32) == cs.PEAKS[row] and rates.bf16 == cs.BF16_PEAKS[row]


# ---------------------------------------------------------------------------
# device_busy on synthetic chrome traces
# ---------------------------------------------------------------------------


def _trace(tmp_path, events) -> Path:
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _ev(cat, ts, dur, name="k", ph="X"):
    return {"ph": ph, "cat": cat, "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize("events, busy, launches", [
    # overlapping: [0, 10) and [5, 20) cover 20 us
    ([_ev("kernel", 0, 10), _ev("kernel", 5, 15)], 20.0, 2),
    # nested: [0, 30) holds [10, 20)
    ([_ev("kernel", 0, 30), _ev("kernel", 10, 10)], 30.0, 2),
    # disjoint: 10 + 5, the gap idle
    ([_ev("kernel", 0, 10), _ev("kernel", 50, 5)], 15.0, 2),
    # copies and sets are device time but not kernel launches
    ([_ev("kernel", 0, 10), _ev("gpu_memcpy", 20, 10), _ev("gpu_memset", 40, 5)], 25.0, 1),
    # host events, and device events of other phases, are not read
    ([_ev("kernel", 0, 10), _ev("cpu_op", 0, 100), _ev("cuda_runtime", 0, 100), _ev("kernel", 0, 50, ph="i")],
     10.0, 1),
])
def test_device_busy_unions_the_device_intervals(tmp_path, events, busy, launches):
    got = cs.device_busy(_trace(tmp_path, events), 100.0)
    assert got["device_busy_us"] == busy and got["busy_share"] == busy / 100.0
    assert got["kernel_launches"] == launches


def test_device_busy_sums_time_by_name(tmp_path):
    events = [_ev("kernel", 0, 10, "conv"), _ev("kernel", 20, 5, "conv"), _ev("gpu_memcpy", 30, 7, "Memcpy DtoH")]
    got = cs.device_busy(_trace(tmp_path, events), 0.0)
    assert got["device_us_by_name"] == {"conv": 15.0, "Memcpy DtoH": 7.0} and got["busy_share"] is None


def test_device_busy_without_device_events_says_so(tmp_path):
    got = cs.device_busy(_trace(tmp_path, [_ev("cpu_op", 0, 10)]), 10.0)
    assert got["device_busy_us"] is None and got["busy_share"] is None
    assert "not measured" in got["note"]


# ---------------------------------------------------------------------------
# ptxas' report
# ---------------------------------------------------------------------------

PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114conv3x3_kernelILi16ELi16ELi4ELb0ELi1EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114conv3x3_kernelILi16ELi16ELi4ELb0ELi1EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z10fsr_kernelILi3EEvPKhPhiiif' for 'sm_90a'
ptxas info    : Function properties for _Z10fsr_kernelILi3EEvPKhPhiiif
    64 bytes stack frame, 48 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 392 bytes cmem[0]
"""


def test_ptxas_registers_without_spills():
    got = cs.ptxas_registers(PTXAS_LOG, r"conv3x3_kernelILi\d+ELi\d+ELi\d+ELb0ELi1E")
    assert got == {"conv3x3_kernelILi16ELi16ELi4ELb0ELi1E": "168 registers, 0 bytes of spill stores"}


def test_ptxas_registers_with_spills_and_no_match():
    assert cs.ptxas_registers(PTXAS_LOG, r"fsr_kernelILi\dE") == {
        "fsr_kernelILi3E": "255 registers, 48 bytes of spill stores"}
    assert cs.ptxas_registers(PTXAS_LOG, r"trunk_kernel\w*") == {}
    assert cs.ptxas_registers("", r"conv3x3_kernel\w*") == {}


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------


def test_conv_work_counts_by_hand():
    # 1x2x3 positions, 128 -> 256: input 6*128 and output 6*256 values, 9*128*256
    # weights and 256 biases, 2 bytes each; 2*9*128 operations per output value
    moved, ops = cs.conv_work(1, 2, 3, 128, 256)
    assert moved == 2 * (6 * 128 + 6 * 256 + 9 * 128 * 256 + 256)
    assert ops == 2 * 9 * 128 * 6 * 256


def test_trunk_work_counts_by_hand():
    x = torch.zeros(2, 4, 5, 128, dtype=torch.bfloat16)
    params = [torch.zeros(3, 3, 128, 128), torch.zeros(128), torch.zeros(3, 3, 128, 256), torch.zeros(256)]
    moved, ops = cs.trunk_work(x, params)
    weights = 9 * 128 * 128 + 128 + 9 * 128 * 256 + 256
    assert moved == 2 * (2 * 4 * 5 * 128 + weights + 2 * 4 * 5 * 256)
    assert ops == cs.conv_work(2, 4, 5, 128, 128)[1] + cs.conv_work(2, 4, 5, 128, 256)[1]


@pytest.mark.parametrize("n, n_ts", [(1, 0), (4, 0), (1, 1), (1, 2)])
def test_resample_work_counts_by_hand(n, n_ts):
    plan = types.SimpleNamespace(in_h=2, in_w=3, out_h=4, out_w=6, kv=2, kh=3, nnz_v=7, nnz_h=11)
    moved, ops = cs.resample_work(plan, n, n_ts)
    frame_in, frame_out, tables = 2 * 3 * 4, 4 * 6 * 4, 4 * (4 * 3 + 6 * 4)
    assert moved == n * frame_in + n * frame_out * (1 + n_ts) + (frame_out if n_ts else 0) + tables
    assert ops == 2 * n * 4 * (7 * 3 + 11 * 4) + 3 * n_ts * frame_out


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------


def test_psnr_reads_rgb_only():
    a = np.zeros((4, 4, 4), np.uint8)
    b = a.copy()
    b[..., 3] = 200  # alpha is not read
    assert cs.psnr(a, b) == float("inf")
    b[..., :3] = 1  # every RGB value 1 LSB off: mse 1
    assert cs.psnr(a, b) == pytest.approx(20 * np.log10(255.0))


def test_plane_psnr_reads_every_value():
    a = np.zeros((6, 8), np.uint8)
    b = a.copy()
    b[0, :2] = 4  # mse 16 * 2 / 48
    assert cs.plane_psnr(a, b) == pytest.approx(10 * np.log10(255.0 ** 2 / (32 / 48)))
    assert cs.plane_psnr(a, a) == float("inf")


def test_lsb_is_the_largest_difference_without_wrapping():
    a = np.array([0, 255, 10], np.uint8)
    b = np.array([255, 0, 12], np.uint8)
    assert cs.lsb(a, b) == 255 and cs.lsb(a, a) == 0


def test_diff_stats_on_u8_tensors():
    x = torch.tensor([0, 255, 7, 9], dtype=torch.uint8)
    y = torch.tensor([3, 250, 7, 9], dtype=torch.uint8)
    assert cs.diff_stats(x, y) == (5, 0.5)


# ---------------------------------------------------------------------------
# the launch reader
# ---------------------------------------------------------------------------


def _counter(**counts):
    mod = types.SimpleNamespace(launches=dict(counts))

    def reset():
        for k in mod.launches:
            mod.launches[k] = 0

    mod.reset_launches = reset
    return mod


def test_launches_reads_each_call_on_its_own_and_totals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    a, b = _counter(conv=5, fsr=0), _counter(warp=2)
    launches_of = cs.Launches(torch, (a, b))

    def call(n_conv, n_warp, out):
        a.launches["conv"] += n_conv
        b.launches["warp"] += n_warp
        return out

    assert launches_of(lambda: call(2, 1, "x")) == ("x", {"conv": 2, "fsr": 0, "warp": 1})
    assert launches_of(lambda: call(0, 3, "y")) == ("y", {"conv": 0, "fsr": 0, "warp": 3})
    assert launches_of.total == {"conv": 2, "fsr": 0, "warp": 4}


def test_ran_keeps_the_kernels_that_launched():
    assert cs.ran({"conv": 2, "fsr": 0, "warp": 1}) == {"conv": 2, "warp": 1}
    assert cs.ran({"conv": 0}) == {}


# ---------------------------------------------------------------------------
# the guarded listing
# ---------------------------------------------------------------------------


def test_guarded_listing_sees_a_file_written_under_a_guarded_directory(tmp_path):
    weights = tmp_path / "weights"
    (tmp_path / "checkpoints" / "a").mkdir(parents=True)
    weights.mkdir()
    (weights / "w.npz").write_bytes(b"0")
    before = cs.guarded_listing(tmp_path, weights)
    assert before[str(tmp_path / "checkpoints_torch")] is None  # absent, not empty
    assert cs.guarded_listing(tmp_path, weights) == before
    (tmp_path / "checkpoints" / "a" / "new.json").write_text("{}")
    after = cs.guarded_listing(tmp_path, weights)
    assert after != before
    assert ("a/new.json" in {p for p, _ in after[str(tmp_path / "checkpoints")]})
