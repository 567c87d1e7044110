"""The port's learned interpolation refinement (mode "flow_soft_ref",
nu_scaler_tpu_torch/models/interp_refine.py and its users in
ops/interpolate.py) against the JAX package's, on the
CPU, with the committed interp_ref4 weights at full width (128 features, 1
block, stride 4) on small frames.

The JAX side reads the port's npz (its `load_checkpoint` patched), so both
serve the same step without orbax. Tolerances:

* the refined mid (the raw-domain serving graph) against JAX's
  `get_refine_graph` run op by op and jitted: ≥ 50 dB RGB, alpha equal
  (measured: bit-equal on 32×64 noise and 74.18 dB on a 64×128 texture, op
  by op and jitted alike; the int8 branch bit-equal op by op and 56.1 dB
  jitted, where XLA keeps `_conv_i8`'s bf16 casts in fp32 inside its
  fusions);
* the whole mode, 2× and the 3× multi form (soft warp in interpret mode on
  the JAX side): ≥ 50 dB RGB, alpha equal;
* the refined 4K upscalers against JAX's, which takes its phase-domain
  resampler where it exists: ≤ 2 LSB and ≥ 50 dB RGB (the phase resampler
  rounds its intermediate to bf16; the port keeps fp32; alpha too may
  differ by that LSB); the port's equal byte for byte to `make_resampler`
  of the refined mid;
* the fp32 twins: ≤ 1e-5.
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.models import interp_refine as ir
from nu_scaler_tpu.ops import interpolate as J
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch import core as pc
from nu_scaler_tpu_torch.kernels import conv_cuda as cc
from nu_scaler_tpu_torch.models import interp_refine as pir
from nu_scaler_tpu_torch.ops import interpolate as P
from nu_scaler_tpu_torch.ops import resample as presample

GATE_DB = 50.0
ROOT = Path(__file__).resolve().parents[1]
JAX_CACHES = (ir.get_refine_graph, ir.get_refine_phase_graph, ir._make_refine_fn, J.make_interpolator,
              J.make_multi_interpolator, J.make_refined_mid_upscaler, J.make_refined_multi_upscaler)


def _clear_caches():
    for fn in JAX_CACHES:
        fn.cache_clear()
    pir.load_model.cache_clear()
    pir._refine_graph.cache_clear()
    for fn in (P._interpolator, P._multi_interpolator, P._refined_mid_upscaler, P._refined_multi_upscaler):
        fn.cache_clear()


@pytest.fixture
def jax_on_port_weights(monkeypatch):
    """The JAX package serving the port's committed npz (no orbax): its
    params tree and step."""
    tree, meta = pir.load_weights()
    params = {"params": tree}
    monkeypatch.setattr(ir, "load_checkpoint", lambda name="interp_ref4": (params, meta["step"]))
    _clear_caches()
    yield params, meta["step"]
    _clear_caches()


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _texture(h: int, w: int, shift: float, alpha=None) -> np.ndarray:
    """A smooth texture moved right by `shift` columns."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 4), np.uint8)
    for c in range(3):
        img[..., c] = np.clip(127.5 + 60.0 * np.sin(2 * np.pi * (x - shift) / 40.0 + c)
                              + 40.0 * np.sin(2 * np.pi * y / 22.0 + 2 * c), 0, 255).astype(np.uint8)
    img[..., 3] = 255 if alpha is None else alpha
    return img


def _triplet(kind: str, h: int, w: int):
    """(a, b, mid) u8 RGBA frames from a numpy seed: seeded noise with a
    random alpha, or a moved texture with its soft-warp-like average mid."""
    rng = np.random.default_rng(7)
    if kind == "noise":
        a = rng.integers(0, 256, (h, w, 4), np.uint8)
        b = np.roll(a, 3, axis=1)
        mid = rng.integers(0, 256, (h, w, 4), np.uint8)
    else:
        alpha = rng.integers(0, 256, (h, w), np.uint8)
        a, b = _texture(h, w, 0.0, alpha), _texture(h, w, 6.0, alpha)
        mid = ((a.astype(int) + b.astype(int)) // 2).astype(np.uint8)
    return a, b, mid


def _check(got: np.ndarray, want: np.ndarray, alpha_equal: bool = True) -> float:
    """RGB ≥ the gate, and alpha equal where both sides carry it through
    unchanged (not through JAX's phase resampler, which rounds its
    intermediate to bf16 and packs by truncation: 255 may come out 254)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if alpha_equal:
        np.testing.assert_array_equal(got[..., 3], want[..., 3])
    db = psnr(got, want)
    assert db >= GATE_DB, f"{db:.2f} dB < {GATE_DB}"
    return db


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_weights_are_the_served_step():
    """The committed npz is the step the JAX package serves (latest.txt), at
    InterpRefineTPU's widths, without an int8 calibration (JAX has none at
    that step either)."""
    latest = int((ROOT / "checkpoints" / "interp_ref4" / "latest.txt").read_text().strip())
    tree, meta = pir.load_weights()
    assert meta["step"] == latest
    jm = ir.InterpRefineTPU()
    assert meta["model"] == {"features": jm.features, "blocks": jm.blocks, "stride": jm.stride}
    assert tree["head"]["kernel"].shape == (3, 3, 16 * 9, 128)
    assert tree["tail"]["kernel"].shape == (3, 3, 128, 16 * 3)
    assert pir.refine_available() and pir.load_act_scales() is None
    assert ir.load_act_scales(latest) is None


def test_missing_or_corrupt_weights_raise(tmp_path, monkeypatch):
    """A sha256 that differs from the sidecar's, a missing npz or a missing
    sidecar raises, and so does building the mode on them: the port never
    falls back to plain flow_soft for want of weights."""
    src = pir.WEIGHTS_DIR
    name = f"{pir.NET}_{pir.load_weights()[1]['step']}"
    monkeypatch.setattr(pir, "WEIGHTS_DIR", tmp_path)
    _clear_caches()
    try:
        with pytest.raises(FileNotFoundError, match="sidecar"):
            pir.load_weights()
        assert not pir.refine_available()
        shutil.copy(src / f"{name}.json", tmp_path)
        with pytest.raises(FileNotFoundError):
            pir.load_weights()
        raw = bytearray((src / f"{name}.npz").read_bytes())
        raw[len(raw) // 2] ^= 0x01
        (tmp_path / f"{name}.npz").write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="sha256"):
            pir.load_weights()
        with pytest.raises(ValueError, match="sha256"):
            P.make_interpolator(16, 256, "flow_soft_ref", device="cpu")
        with pytest.raises(ValueError, match="sha256"):
            pc.WgpuFrameInterpolator(mode="flow_soft_ref", device="cpu").interpolate_py(
                bytes(16 * 256 * 4), bytes(16 * 256 * 4), 256, 16)
    finally:
        _clear_caches()


def test_float_twin_matches_jax(jax_on_port_weights):
    """`make_apply` (the fp32 float-domain forward) against JAX's, and the
    served bf16 graph within a mean LSB of the twin, as
    tests/test_interp_refine.py holds JAX's."""
    params, _ = jax_on_port_weights
    a, b, mid = _triplet("texture", 32, 64)
    f01 = [t[None, ..., :3].astype(np.float32) / 255.0 for t in (a, b, mid)]
    want = np.asarray(ir.make_apply(params)(*(jnp.asarray(x) for x in f01)))
    got = pir.make_apply()(*(_t(x) for x in f01)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    served = pir.get_refine_graph(32, 64, "cpu")(_t(a), _t(b), _t(mid)).numpy()
    tw8 = np.clip(np.round(got[0] * 255.0), 0, 255).astype(np.uint8)
    assert np.abs(served[..., :3].astype(int) - tw8).mean() < 1.0


# ---------------------------------------------------------------------------
# the serving graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind, h, w", [("noise", 32, 64), ("texture", 64, 128)])
def test_refined_mid_matches_jax(jax_on_port_weights, kind, h, w):
    """The refined mid against JAX's `get_refine_graph` run op by op and
    jitted (`refine_mid`), on the same (a, b, mid)."""
    a, b, mid = _triplet(kind, h, w)
    got = pir.refine_mid(_t(a), _t(b), _t(mid), device="cpu").numpy()
    eager = np.asarray(ir.get_refine_graph(h, w)(*(jnp.asarray(x) for x in (a, b, mid))))
    jitted = np.asarray(ir.refine_mid(*(jnp.asarray(x) for x in (a, b, mid))))
    _check(got, eager)
    _check(got, jitted)
    # the graph did refine: it moved the mid
    assert not np.array_equal(got, mid)


def test_phases_are_the_phase_graph(jax_on_port_weights):
    """`phases_of` is JAX's `get_refine_phase_graph`: f32, integer-valued,
    channel (row phase, column phase, RGBA)."""
    a, b, mid = _triplet("texture", 32, 64)
    got = pir.get_refine_graph(32, 64, "cpu").phases_of(_t(a), _t(b), _t(mid)).numpy()
    want = np.asarray(ir.get_refine_phase_graph(32, 64)(*(jnp.asarray(x) for x in (a, b, mid))))
    assert got.shape == want.shape == (8, 16, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.round(got))
    assert np.abs(got - want).max() <= 1.0 and np.mean(got == want) >= 0.99


def test_serving_graph_runs_four_convs(monkeypatch):
    """The graph's convs go through the conv kernel's wrapper, at its widths:
    4 calls a mid (head 256 -> 128, two block convs 128 -> 128, tail 128 ->
    128), round_sum as the learned tier serves, and no int8-grid call."""
    seen, seen_q = [], []
    real = cc.conv3x3

    def spy(x, k, b, relu=False, round_sum=False):
        seen.append((x.shape[-1], k.shape[-1], relu, round_sum))
        return real(x, k, b, relu, round_sum)

    monkeypatch.setattr(cc, "conv3x3", spy)
    monkeypatch.setattr(cc, "conv3x3_q", lambda *a, **k: seen_q.append(1))
    a, b, mid = _triplet("noise", 32, 64)
    graph = pir.RefineGraph(pir.load_model()[0], 32, 64, "cpu")
    want = pir.RefineGraph(pir.load_model()[0], 32, 64, "cpu", conv=cc.conv3x3_plain)(_t(a), _t(b), _t(mid))
    got = graph(_t(a), _t(b), _t(mid))
    assert torch.equal(got, want)
    assert seen == [(256, 128, False, True), (128, 128, True, True), (128, 128, False, True),
                    (128, 128, False, True)]
    assert graph.convs_per_frame == 4 and not graph.quantized and seen_q == []


def test_int8_branch_matches_jax(jax_on_port_weights, monkeypatch, tmp_path):
    """With int8 scales (JAX's calibration, saved at the served step under
    tmp_path) both graphs run the int8 convs: the port's on
    `conv_cuda.conv3x3_q`'s plain version, against JAX's graph op by op and
    jitted, and the fp32 int8-grid twins against each other."""
    params, step = jax_on_port_weights
    monkeypatch.setattr(ir, "CKPT_DIR", str(tmp_path))
    a, b, mid = _triplet("noise", 32, 64)
    a[..., 3] = 255
    f01 = [t[None, ..., :3].astype(np.float32) / 255.0 for t in (a, b, mid)]
    scales = ir.calibrate_scales(params, crops=np.concatenate(f01, axis=-1))
    assert set(scales) == {"head", "block0/conv1", "block0/conv2", "tail"}
    ir.save_act_scales(scales, step=step)
    calls = []
    graph = pir.RefineGraph(pir.load_model()[0], 32, 64, "cpu", quant_scales=scales,
                            conv_q=lambda *args: calls.append(1) or cc.conv3x3_q(*args))
    got = graph(_t(a), _t(b), _t(mid)).numpy()
    assert graph.quantized and len(calls) == 4
    eager = np.asarray(ir.get_refine_graph(32, 64)(*(jnp.asarray(x) for x in (a, b, mid))))
    jitted = np.asarray(ir.refine_mid(*(jnp.asarray(x) for x in (a, b, mid))))
    np.testing.assert_array_equal(got, eager)
    _check(got, jitted)
    want = np.asarray(ir.make_quant_apply(params, scales)(*(jnp.asarray(x) for x in f01)))
    twin = pir.make_quant_apply(pir.load_model()[0], scales)(*(_t(x) for x in f01)).numpy()
    assert np.abs(twin - want).max() <= 1e-5


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, w", [(16, 8), (30, 62), (32, 64), (36, 200), (64, 128), (100, 252)])
def test_refine_serves_as_jax(h, w):
    assert P.refine_serves(h, w) == J.refine_serves(h, w)
    assert P.REFINE_MIN_ROWS == J.REFINE_MIN_ROWS


def test_mode_matches_jax(jax_on_port_weights):
    """make_interpolator(…, "flow_soft_ref") at 2× and make_multi_interpolator
    at 3× against JAX's on a frame the warp tile divides (the soft warp
    kernel's plain version here, the Pallas kernel in interpret mode
    there)."""
    h, w = 32, 256
    alpha = np.random.default_rng(3).integers(0, 256, (h, w), np.uint8)
    a, b = _texture(h, w, 0.0, alpha), _texture(h, w, 5.0, alpha)
    got = P.make_interpolator(h, w, "flow_soft_ref", "cpu")(_t(a), _t(b), 0.5).numpy()
    want = np.asarray(J.make_interpolator(h, w, "flow_soft_ref")(jnp.asarray(a), jnp.asarray(b), 0.5))
    _check(got, want)
    soft = P.make_interpolator(h, w, "flow_soft", "cpu")(_t(a), _t(b), 0.5).numpy()
    assert not np.array_equal(got, soft)
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got3 = P.make_multi_interpolator(h, w, ts, "flow_soft_ref", "cpu")(_t(a), _t(b)).numpy()
    want3 = np.asarray(J.make_multi_interpolator(h, w, ts, "flow_soft_ref")(jnp.asarray(a), jnp.asarray(b)))
    assert got3.shape == want3.shape == (2, h, w, 4)
    for g, wnt in zip(got3, want3):
        _check(g, wnt)


def test_api_serves_the_mode(jax_on_port_weights):
    """WgpuFrameInterpolator(mode="flow_soft_ref"): interpolate_py is the
    mode's mid, interpolate_multi_py its multi form (the mode is kept, as
    nu_scaler_core maps it) with the same bytes as the single calls, and
    against nu_scaler_core's class ≥ 50 dB."""
    import nu_scaler_core as nsc

    h, w = 32, 256
    a, b = _texture(h, w, 0.0), _texture(h, w, 5.0)
    fi = pc.WgpuFrameInterpolator(mode="flow_soft_ref", device="cpu")
    mid = fi.interpolate_py(a.tobytes(), b.tobytes(), w, h)
    want = P.make_interpolator(h, w, "flow_soft_ref", "cpu")(_t(a), _t(b), 0.5).numpy()
    assert mid == want.tobytes()
    ts = (1.0 / 3.0, 2.0 / 3.0)
    mids = fi.interpolate_multi_py(a.tobytes(), b.tobytes(), w, h, times=ts)
    assert mids == [fi.interpolate_py(a.tobytes(), b.tobytes(), w, h, time_t=t) for t in ts]
    jmid = nsc.WgpuFrameInterpolator(mode="flow_soft_ref").interpolate_py(a.tobytes(), b.tobytes(), w, h)
    _check(np.frombuffer(mid, np.uint8).reshape(h, w, 4), np.frombuffer(jmid, np.uint8).reshape(h, w, 4))


@pytest.mark.parametrize("h, w", [(30, 62), (32, 62)])
def test_ragged_frame_serves_flow_soft(jax_on_port_weights, h, w):
    """A side not a multiple of 4: the mode serves the plain flow_soft mid,
    as JAX's does (`refine_serves` false)."""
    a, b = _texture(h, w, 0.0), _texture(h, w, 3.0)
    got = P.make_interpolator(h, w, "flow_soft_ref", "cpu")(_t(a), _t(b), 0.5)
    soft = P.make_interpolator(h, w, "flow_soft", "cpu")(_t(a), _t(b), 0.5)
    assert torch.equal(got, soft)
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got3 = P.make_multi_interpolator(h, w, ts, "flow_soft_ref", "cpu")(_t(a), _t(b))
    assert torch.equal(got3, P.make_multi_interpolator(h, w, ts, "flow_soft", "cpu")(_t(a), _t(b)))
    assert torch.equal(pir.refine_mid(_t(a), _t(b), soft), soft)
    want = np.asarray(J.make_interpolator(h, w, "flow_soft_ref")(jnp.asarray(a), jnp.asarray(b), 0.5))
    _check(got.numpy(), want)


def test_timing_api_reports_refine_ms():
    """The timing API of "flow_soft_ref" on a frame the warp tile divides:
    JAX's keys, refine_ms the total less flow and warp, floored at 0."""
    h, w = 16, 256
    fi = pc.WgpuFrameInterpolator(mode="flow_soft_ref", device="cpu")
    a, b = _texture(h, w, 0.0), _texture(h, w, 2.0)
    fi.interpolate_py(a.tobytes(), b.tobytes(), w, h)
    detail = fi.get_last_gpu_duration_detail()
    assert set(detail) == {"total_ms", "flow_ms", "warp_ms", "refine_ms", "wall_ms"}
    assert detail["refine_ms"] == max(detail["total_ms"] - detail["flow_ms"] - detail["warp_ms"], 0.0)
    assert fi.get_last_gpu_duration_ms() == detail["total_ms"] > 0


# ---------------------------------------------------------------------------
# the refined 4K upscalers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(32, 64, 64, 128), (32, 64, 45, 91), (64, 128, 32, 64), (30, 62, 60, 124)])
@pytest.mark.parametrize("algorithm", ["lanczos3", "bilinear", "nearest"])
def test_refined_upscaler_is_the_resample_of_the_mode(sizes, algorithm):
    """make_refined_mid_upscaler is `make_resampler` of the mode's mid,
    byte for byte, at every algorithm, at integer, non-integer and
    downscaling ratios, and where the refinement does not serve (30×62:
    the plain flow_soft mid)."""
    h, w, oh, ow = sizes
    a, b = _texture(h, w, 0.0), _texture(h, w, 3.0)
    up = P.make_refined_mid_upscaler(h, w, oh, ow, algorithm, device="cpu")
    assert (up.ref is not None) == P.refine_serves(h, w)
    mid = P.make_interpolator(h, w, "flow_soft_ref", "cpu")(_t(a), _t(b), 0.25)
    got = up(a, b, 0.25).numpy()
    assert got.shape == (oh, ow, 4)
    assert np.array_equal(got, presample.make_resampler(h, w, oh, ow, algorithm, "cpu")(mid).numpy())


@pytest.mark.parametrize("algorithm", ["lanczos3", "bilinear", "nearest"])
def test_refined_multi_upscaler_is_the_single_calls(algorithm):
    """make_refined_multi_upscaler at t = (1/4, 1/2, 3/4): each mid the
    bytes of make_refined_mid_upscaler at that t."""
    h, w, oh, ow = 32, 64, 48, 96
    a, b = _texture(h, w, 0.0), _texture(h, w, 4.0)
    ts = (0.25, 0.5, 0.75)
    got = P.make_refined_multi_upscaler(h, w, oh, ow, ts, algorithm, device="cpu")(a, b).numpy()
    single = P.make_refined_mid_upscaler(h, w, oh, ow, algorithm, device="cpu")
    assert got.shape == (len(ts), oh, ow, 4)
    for t, g in zip(ts, got):
        assert np.array_equal(g, single(a, b, t).numpy())


def test_refined_upscalers_match_jax(jax_on_port_weights):
    """make_refined_mid_upscaler and make_refined_multi_upscaler at 136×256 →
    272×512 (where JAX's takes its phase resampler): ≤ 2 LSB and ≥ 50 dB of
    JAX's, and the port's bytes those of make_resampler of the refined mid."""
    h, w, oh, ow = 136, 256, 272, 512
    a, b = _texture(h, w, 0.0), _texture(h, w, 5.0)
    up = P.make_refined_mid_upscaler(h, w, oh, ow, device="cpu")
    assert up.ref is not None
    got = up(a, b, 0.5).numpy()
    want = np.asarray(J.make_refined_mid_upscaler(h, w, oh, ow)(jnp.asarray(a), jnp.asarray(b), 0.5))
    assert np.abs(got.astype(int) - want).max() <= 2
    _check(got, want, alpha_equal=False)
    mid = P.make_interpolator(h, w, "flow_soft_ref", "cpu")(_t(a), _t(b), 0.5)
    assert np.array_equal(got, presample.make_resampler(h, w, oh, ow, "lanczos3", "cpu")(mid).numpy())
    ts = (1.0 / 3.0, 2.0 / 3.0)
    got3 = P.make_refined_multi_upscaler(h, w, oh, ow, ts, device="cpu")(a, b).numpy()
    want3 = np.asarray(J.make_refined_multi_upscaler(h, w, oh, ow, ts)(jnp.asarray(a), jnp.asarray(b)))
    assert got3.shape == want3.shape == (2, oh, ow, 4)
    for t, g, wnt in zip(ts, got3, want3):
        assert np.abs(g.astype(int) - wnt).max() <= 2
        _check(g, wnt, alpha_equal=False)
        assert np.array_equal(g, up(a, b, t).numpy())


@pytest.mark.parametrize("sizes, refined", [((30, 62, 60, 124), False), ((32, 64, 64, 128), True)])
def test_refined_upscaler_fallbacks(jax_on_port_weights, sizes, refined):
    """Where the refinement does not serve, the plain flow_soft mid is
    resampled; where it serves but JAX's phase resampler does not exist,
    the u8 refined mid is (`make_resampler`), as in the JAX package; against
    JAX's ≤ 2 LSB."""
    h, w, oh, ow = sizes
    a, b = _texture(h, w, 0.0), _texture(h, w, 3.0)
    up = P.make_refined_mid_upscaler(h, w, oh, ow, device="cpu")
    assert (up.ref is not None) == refined
    mid = P.make_interpolator(h, w, "flow_soft_ref" if refined else "flow_soft", "cpu")(_t(a), _t(b), 0.5)
    got = up(a, b, 0.5).numpy()
    assert np.array_equal(got, presample.make_resampler(h, w, oh, ow, "lanczos3", "cpu")(mid).numpy())
    want = np.asarray(J.make_refined_mid_upscaler(h, w, oh, ow)(jnp.asarray(a), jnp.asarray(b), 0.5))
    assert np.abs(got.astype(int) - want).max() <= 2
