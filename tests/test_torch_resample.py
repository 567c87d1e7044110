"""The port's resample (nu_scaler_tpu_torch) against the numpy goldens and
against the JAX package's Pallas kernels, on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions (two
fp32 matmuls on the same tap tables the CUDA kernel reads); the JAX kernels
run in Pallas interpret mode. Tolerances:

* nearest: bit-exact (0/1 weights, no rounding anywhere).
* other algorithms vs the float64 golden: ≤1 LSB and ≥50 dB. The port sums in
  fp32, so a value that sits on an integer boundary can truncate to either
  side.
* port vs the Pallas kernels: ≤2 LSB. The Pallas kernels round the vertical
  intermediate to bf16 and split the weights into bf16 hi/lo halves; the
  port keeps fp32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels import reference as jref
from nu_scaler_tpu.kernels.resample_pallas import (
    make_pallas_fused,
    make_pallas_fused_batched,
    make_pallas_fused_blend,
)
from nu_scaler_tpu.ops import resample as jresample
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch.kernels import reference as pref
from nu_scaler_tpu_torch.kernels import resample_cuda as rc
from nu_scaler_tpu_torch.ops import resample as presample

# (in_h, in_w, out_h, out_w): a 2× scale that tiles, an awkward upscale that
# does not, and a downscale
SCALES = [(32, 48, 64, 96), (30, 50, 77, 101), (64, 96, 40, 52)]
PALLAS_SHAPE = (128, 256, 256, 512)  # as tests/test_pallas_kernels.py runs them


def _diff_stats(a: np.ndarray, b: np.ndarray) -> tuple[int, float, dict]:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    vals, counts = np.unique(d, return_counts=True)
    return int(d.max()), float((d == 0).mean()), dict(zip(vals.tolist(), counts.tolist()))


@pytest.mark.parametrize("scale", SCALES, ids=["2x", "awkward", "down"])
@pytest.mark.parametrize("algo", ["nearest", "bilinear", "bicubic", "lanczos3"])
def test_port_matches_golden(rng, algo, scale):
    in_h, in_w, out_h, out_w = scale
    img = rng.integers(0, 256, (in_h, in_w, 4), np.uint8)
    out = presample.make_resampler(in_h, in_w, out_h, out_w, algo, device="cpu")(img).numpy()
    assert out.shape == (out_h, out_w, 4) and out.dtype == np.uint8
    if algo == "nearest":
        np.testing.assert_array_equal(out, jref.nearest_ref(img, out_h, out_w))
        return
    golden = jref.separable_resample_ref(img, out_h, out_w, algo)
    max_d, exact, hist = _diff_stats(out, golden)
    print(f"{algo} {scale}: max {max_d} LSB, exact {exact:.6f}, hist {hist}")
    assert max_d <= 1
    assert psnr(out, golden) >= 50.0


@pytest.mark.parametrize("algo", list(presample.ALGORITHMS))
def test_taps_from_matrix_shared_with_jax(algo):
    """The tap tables built from the JAX package's axis matrices equal those
    built from the port's own copy of `filter_weights`, and they carry every
    weight of the dense matrix: at the main path's width and a downscale."""
    for in_size, out_size in ((1920, 3840), (96, 52)):
        _check_taps(algo, in_size, out_size)


def _check_taps(algo, in_size, out_size):
    w_jax = jresample._axis_weights(in_size, out_size, algo)
    w_port = presample.axis_weights(in_size, out_size, algo)
    np.testing.assert_array_equal(w_port, w_jax)
    first_j, taps_j = rc.taps_from_matrix(w_jax)
    first_p, taps_p = rc.taps_from_matrix(w_port)
    np.testing.assert_array_equal(first_p, first_j)
    np.testing.assert_array_equal(taps_p, taps_j)
    assert first_p.dtype == np.int32 and taps_p.dtype == np.float32
    assert np.all(np.diff(first_p) >= 0)  # the kernel's footprint needs it
    assert first_p.min() >= 0 and first_p.max() + taps_p.shape[1] <= in_size
    np.testing.assert_array_equal(rc.dense_from_taps(first_p, taps_p, in_size), w_jax)


def test_taps_at_main_shape():
    """lanczos3 at 2× reads a band of 6 inputs per output; the default
    64×128 tile reads a 38×70 footprint, a run of 8 output rows a window of
    10 input rows, a group of 4 output columns 8 intermediate columns, and
    with two footprint buffers two blocks share an SM's shared memory."""
    fv, wv = rc.taps_from_matrix(presample.axis_weights(1080, 2160, "lanczos3"))
    fh, wh = rc.taps_from_matrix(presample.axis_weights(1920, 3840, "lanczos3"))
    assert wv.shape == (2160, 6) and wh.shape == (3840, 6)
    assert rc.footprint(fv, 6, 64) == 38 and rc.footprint(fh, 6, 128) == 70
    plan = rc.tile_plan(fv, 6, fh, 6)
    fcw = 76  # 70 + 3 pixels of alignment slack, rounded up to 4
    tables = 8 * 10 * 8 * 4 + 8 * 4 + 8 * 32 * 16 + 32 * 4
    smem = 2 * 38 * fcw * 4 + 2 * tables + 70 * 65 * 16
    assert plan == rc.TilePlan(64, 128, 38, 70, 10, 8, 2, smem)
    assert plan.smem == rc.smem_bytes(64, 128, 38, 70, 10, 8, 2) <= rc.SMEM_LIMIT // 2


def test_tile_plan_shrinks_for_wide_footprints():
    """A 16× downscale has a 97-tap band: the tile shrinks (down to one
    footprint buffer) until the footprint fits, and a footprint that cannot
    fit raises."""
    fv, wv = rc.taps_from_matrix(presample.axis_weights(2048, 128, "lanczos3"))
    plan = rc.tile_plan(fv, wv.shape[1], fv, wv.shape[1])
    assert (plan.tile_h, plan.tile_w) < (rc.TILE_H, rc.TILE_W) and plan.smem <= rc.SMEM_LIMIT
    assert plan.nbuf == 1
    with pytest.raises(ValueError, match="multiple of"):
        rc.tile_plan(fv, wv.shape[1], fv, wv.shape[1], tile=(12, 8))
    fe, we = rc.taps_from_matrix(presample.axis_weights(4096, 4, "lanczos3"))
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        rc.tile_plan(fe, we.shape[1], fe, we.shape[1])


@pytest.mark.parametrize("algo", ["nearest", "bilinear", "lanczos3", "area"])
@pytest.mark.parametrize("in_size, out_size", [(1080, 2160), (2160, 1080), (1366, 1920), (37, 200)])
def test_band_tables_hold_every_tap(algo, in_size, out_size):
    """The kernel's dense bands (`band_tables`) for the tiling it plans:
    each output's weights sit at its own taps' inputs, relative to its tile's
    first input, and nowhere else, so the dense chain is the chain of its
    taps; outputs past the axis have no weights."""
    first, taps = rc.taps_from_matrix(presample.axis_weights(in_size, out_size, algo))
    n_out, k = taps.shape
    for tile, run in ((rc.tile_plan(first, k, first, k).tile_h, rc.RUN),
                      (rc.tile_plan(first, k, first, k).tile_w, rc.GROUP)):
        window = rc.footprint(first, k, run)
        w, starts = rc.band_tables(first, taps, tile, run, window)
        assert w.shape == (-(-n_out // tile), tile // run, window, run) and w.dtype == np.float32
        assert starts.shape[1] % 4 == 0 and starts.dtype == np.int32
        dense = np.zeros((n_out, in_size), np.float32)
        for i, b, j, e in zip(*np.nonzero(w)):
            o = i * tile + b * run + e
            assert o < n_out and dense[o, first[i * tile] + starts[i, b] + j] == 0
            dense[o, first[i * tile] + starts[i, b] + j] = w[i, b, j, e]
            # inside its tile's footprint: the kernel clamps window positions
            # past it, where every weight is 0
            last = min((i + 1) * tile, n_out) - 1
            assert starts[i, b] + j < first[last] + k - first[i * tile]
        np.testing.assert_array_equal(dense, rc.dense_from_taps(first, taps, in_size))


@pytest.mark.parametrize("algo", ["nearest", "bilinear", "bicubic", "lanczos3", "area"])
def test_reference_copy_matches_jax(rng, algo):
    """The port's numpy goldens are the JAX package's, value for value."""
    img = rng.integers(0, 256, (20, 30, 4), np.uint8)
    if algo == "nearest":
        np.testing.assert_array_equal(pref.nearest_ref(img, 41, 59), jref.nearest_ref(img, 41, 59))
    else:
        np.testing.assert_array_equal(
            pref.separable_resample_ref(img, 41, 59, algo),
            jref.separable_resample_ref(img, 41, 59, algo),
        )
    f = rng.random((8, 8, 4)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(pref.pack_u8_trunc(f), jref.pack_u8_trunc(f))
    np.testing.assert_array_equal(pref.pack_u8_round(f), jref.pack_u8_round(f))
    np.testing.assert_array_equal(pref.unpack_u8(img), jref.unpack_u8(img))


@pytest.mark.parametrize("algo", ["lanczos3", "bilinear", "nearest"])
def test_port_matches_pallas_fused(rng, algo):
    in_h, in_w, out_h, out_w = PALLAS_SHAPE
    img = rng.integers(0, 256, (in_h, in_w, 4), np.uint8)
    jax_out = np.asarray(make_pallas_fused(in_h, in_w, out_h, out_w, algo)(jnp.asarray(img)))
    port = presample.make_resampler(in_h, in_w, out_h, out_w, algo, device="cpu")(img).numpy()
    max_d, exact, hist = _diff_stats(port, jax_out)
    print(f"port vs make_pallas_fused {algo}: max {max_d} LSB, exact {exact:.6f}, hist {hist}")
    assert max_d <= 2
    if algo == "nearest":
        np.testing.assert_array_equal(port, jax_out)


def test_port_matches_pallas_fused_batched(rng):
    n = 3
    in_h, in_w, out_h, out_w = PALLAS_SHAPE
    frames = rng.integers(0, 256, (n, in_h, in_w, 4), np.uint8)
    fn = make_pallas_fused_batched(n, in_h, in_w, out_h, out_w, "lanczos3")
    jax_out = np.asarray(fn(jnp.asarray(frames)))
    rs = presample.make_resampler(in_h, in_w, out_h, out_w, "lanczos3", device="cpu")
    port = rs(frames).numpy()
    assert port.shape == (n, out_h, out_w, 4)
    max_d, exact, hist = _diff_stats(port, jax_out)
    print(f"port vs make_pallas_fused_batched: max {max_d} LSB, exact {exact:.6f}, hist {hist}")
    assert max_d <= 2
    for i in range(n):  # the batch is the single-frame resample per frame
        np.testing.assert_array_equal(port[i], rs(frames[i]).numpy())


@pytest.mark.parametrize("ts", [(0.5,), (1 / 3, 2 / 3)], ids=["2x", "3x"])
def test_port_matches_pallas_fused_blend(rng, ts):
    in_h, in_w, out_h, out_w = PALLAS_SHAPE
    cur = rng.integers(0, 256, (in_h, in_w, 4), np.uint8)
    prev = rng.integers(0, 256, (out_h, out_w, 4), np.uint8)
    fb = make_pallas_fused_blend(in_h, in_w, out_h, out_w, "lanczos3", ts)
    prev_2d = np.zeros(fb.out2d, np.uint8)
    prev_2d[:out_h, : out_w * 4] = prev.reshape(out_h, out_w * 4)
    jax_outs = [
        np.asarray(o)[:out_h, : out_w * 4].reshape(out_h, out_w, 4)
        for o in fb(jnp.asarray(cur), jnp.asarray(prev_2d))
    ]
    step = presample.make_fused_blend(in_h, in_w, out_h, out_w, "lanczos3", ts, device="cpu")
    port_outs = [o.numpy() for o in step(cur, torch.from_numpy(prev))]
    assert len(port_outs) == len(jax_outs) == 1 + len(ts)
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        max_d, exact, hist = _diff_stats(p, j)
        print(f"port vs make_pallas_fused_blend {ts} output {i}: max {max_d} LSB, "
              f"exact {exact:.6f}, hist {hist}")
        assert max_d <= 2
    # each mid is the exact round-mix of the port's own truncated upscale
    cur_up = port_outs[0].astype(np.float32)
    a = prev.astype(np.float32)
    for t, mid in zip(ts, port_outs[1:]):
        want = np.clip(np.round(a + (cur_up - a) * np.float32(t)), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(mid, want)


def test_fused_blend_first_step_is_the_resample(rng):
    """prev_up=None runs the plain resample: the same frame as the resampler."""
    cur = rng.integers(0, 256, (24, 40, 4), np.uint8)
    step = presample.make_fused_blend(24, 40, 48, 80, "lanczos3", 0.5, device="cpu")
    (up,) = step(cur, None)
    np.testing.assert_array_equal(
        up.numpy(), presample.make_resampler(24, 40, 48, 80, "lanczos3", "cpu")(cur).numpy()
    )
    assert step.out_hw == (48, 80) and step.ts == (0.5,)


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda p: rc.resample_fused(torch.zeros((8, 8, 4), dtype=torch.int32), p), "uint8"),
        (lambda p: rc.resample_fused(torch.zeros((9, 8, 4), dtype=torch.uint8), p), "shape"),
        (lambda p: rc.resample_fused_batched(torch.zeros((8, 8, 4), dtype=torch.uint8), p), r"\[N, H, W, 4\]"),
        (lambda p: rc.resample_fused_blend(
            torch.zeros((8, 8, 4), dtype=torch.uint8), torch.zeros((16, 16, 4), dtype=torch.uint8),
            p, (0.25, 0.5, 0.75)), "1 to 2 times"),
        (lambda p: rc.resample_fused_blend(
            torch.zeros((8, 8, 4), dtype=torch.uint8), torch.zeros((8, 8, 4), dtype=torch.uint8),
            p, (0.5,)), "prev"),
    ],
    ids=["dtype", "shape", "batch-rank", "too-many-times", "prev-shape"],
)
def test_wrappers_validate_inputs(call, match):
    plan = rc.ResamplePlan(
        presample.axis_weights(8, 16, "bilinear"), presample.axis_weights(8, 16, "bilinear"), "cpu"
    )
    with pytest.raises((TypeError, ValueError), match=match):
        call(plan)


def test_cpu_path_never_builds_or_counts(rng, monkeypatch):
    """On a CPU tensor the wrappers run the plain version: no kernel build,
    no launch counted."""
    from nu_scaler_tpu_torch.kernels import _build

    def _no_build(*_):  # pragma: no cover - only fires on regression
        raise AssertionError("the CPU path must not build the CUDA kernel")

    monkeypatch.setattr(_build, "load_library", _no_build)
    rc.reset_launches()
    img = rng.integers(0, 256, (2, 16, 24, 4), np.uint8)
    rs = presample.make_resampler(16, 24, 32, 48, "lanczos3", device="cpu")
    rs(img)
    rs(img[0])
    presample.make_fused_blend(16, 24, 32, 48, "lanczos3", device="cpu")(img[0], rs(img[1]))
    assert rc.launches == {k: 0 for k in rc.launches}


@pytest.mark.parametrize("algo", ["lanczos3", "bilinear", "bicubic"])
def test_port_closer_to_golden_than_pallas(rng, algo):
    """The port keeps the vertical intermediate in fp32, so it sits closer to
    the float64 golden than the Pallas kernel with its bf16 intermediate."""
    in_h, in_w, out_h, out_w = PALLAS_SHAPE
    img = rng.integers(0, 256, (in_h, in_w, 4), np.uint8)
    golden = jref.separable_resample_ref(img, out_h, out_w, algo)
    jax_out = np.asarray(make_pallas_fused(in_h, in_w, out_h, out_w, algo)(jnp.asarray(img)))
    port = presample.make_resampler(in_h, in_w, out_h, out_w, algo, device="cpu")(img).numpy()
    _, exact_jax, _ = _diff_stats(jax_out, golden)
    _, exact_port, _ = _diff_stats(port, golden)
    print(f"{algo}: exact vs golden, port {exact_port:.6f}, Pallas {exact_jax:.6f}")
    assert exact_port >= exact_jax
    assert psnr(port, golden) >= psnr(jax_out, golden)
