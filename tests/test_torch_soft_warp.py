"""The port's overlapped-tile soft warp (nu_scaler_tpu_torch.kernels.soft_warp_cuda)
against the numpy golden, the JAX Pallas kernel and the JAX XLA soft twin, on
the CPU.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel's
function, op for op); the Pallas kernel runs in interpret mode. Tolerances:

* port vs `soft_warp_blend_ref` (float64): ≤1 LSB. The port and the kernel
  it stands for mix in fp32, so a value near a .5 boundary can round to the
  other side.
* port vs the Pallas kernel: ≤ the Pallas kernel's own bound against the
  golden in tests/test_soft_warp_pallas.py (1 LSB on uniform flow, 2 on
  varying flow) plus 1 LSB. The Pallas v7 schedule skips the corner weights
  where all four corners share a candidate; the port always applies them.
* zero motion: within 1 LSB of the float64 cross-fade.
* port vs the XLA soft twin (`warp_blend_fast(overlap=True, pallas_ok=False)`)
  on the same tile motion: RGB ≥ 50 dB, the gate of bench.py:835-853, on
  the motion that gate sees (the twin splits its column lerp and keeps bf16
  accumulators; it cross-fades alpha, so alpha is left out). Where the motion
  changes by pixels from tile to tile the twin departs from the Pallas kernel
  and the port alike (43-49 dB on the varying case here, where the port and
  the Pallas kernel agree within 1 LSB); that is the twin's approximation.

Tile means are kept off integers (+0.13), as in the JAX tests: a mean that
sits on an integer can floor either way under another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nu_scaler_tpu.kernels import soft_warp_pallas as SW
from nu_scaler_tpu.ops import interpolate as jinterp
from nu_scaler_tpu.ops.metrics import psnr
from nu_scaler_tpu_torch.kernels import reference as pref
from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc

# (tile, frame shape): the (8, 32) case of tests/test_soft_warp_pallas.py and
# the production (8, 128) tile
SHAPES = [((8, 32), (24, 96)), ((8, 128), (16, 256))]
TIMES = [0.5, 1.0 / 3.0, 0.3]
RNG = 8  # motion range of the small cases (as tests/test_soft_warp_pallas.py)


def _diff(a, b) -> tuple[int, float, dict]:
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    vals, counts = np.unique(d, return_counts=True)
    return int(d.max()), float((d == 0).mean()), dict(zip(vals.tolist(), counts.tolist()))


def _case(seed: int, tile, shape, motion: str):
    """Frames a, b and tile motion [Ty, Tx, 2] (x, y), kept off integers."""
    rng = np.random.default_rng(seed)
    (th, tw), (h, w) = tile, shape
    ty, tx = h // th, w // tw
    a = rng.integers(0, 256, (h, w, 4), np.uint8)
    if motion == "uniform":
        b = np.roll(a, 3, axis=1)
        tiles = np.broadcast_to(np.array([3.13, 0.13], np.float32), (ty, tx, 2)).copy()
    else:
        b = rng.integers(0, 256, (h, w, 4), np.uint8)
        gx, gy = np.meshgrid(np.linspace(-5, 5, tx), np.linspace(-3, 3, ty))
        tiles = (np.stack([gx, gy], axis=-1) + 0.13).astype(np.float32)
    return a, b, tiles


def _dense(tiles: np.ndarray, tile) -> np.ndarray:
    return np.repeat(np.repeat(tiles, tile[0], axis=0), tile[1], axis=1)


def _port(a, b, tiles, t, tile, k, rng=RNG) -> np.ndarray:
    out = swc.soft_warp_blend(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(tiles), t, tile, rng=rng, k=k
    )
    assert out.dtype == torch.uint8 and tuple(out.shape) == a.shape
    return out.numpy()


@pytest.mark.parametrize("t", TIMES, ids=["t0.5", "t1_3", "t0.3"])
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("motion", ["uniform", "varying"])
@pytest.mark.parametrize("tile, shape", SHAPES, ids=["tile8x32", "tile8x128"])
def test_plain_matches_golden(tile, shape, motion, k, t):
    a, b, tiles = _case(11, tile, shape, motion)
    port = _port(a, b, tiles, t, tile, k)
    golden = pref.soft_warp_blend_ref(a, b, _dense(tiles, tile), t, tile, rng=RNG, k=k)
    max_d, exact, hist = _diff(port, golden)
    print(f"{tile} {motion} k={k} t={t:.4f}: port vs golden max {max_d} LSB, exact {exact:.6f}, hist {hist}")
    assert max_d <= 1


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("motion", ["uniform", "varying"])
@pytest.mark.parametrize("tile, shape", SHAPES, ids=["tile8x32", "tile8x128"])
def test_plain_vs_pallas_kernel(tile, shape, motion, k):
    """All three times on one compiled Pallas program per (shape, k)."""
    a, b, tiles = _case(12, tile, shape, motion)
    bound = (1 if motion == "uniform" else 2) + 1
    for t in TIMES:
        port = _port(a, b, tiles, t, tile, k)
        jax_out = np.asarray(SW.soft_warp_blend(
            jnp.asarray(a), jnp.asarray(b), None, t, tile=tile, rng=RNG, k=k,
            tiles=jnp.asarray(tiles),
        ))
        golden = pref.soft_warp_blend_ref(a, b, _dense(tiles, tile), t, tile, rng=RNG, k=k)
        max_d, exact, hist = _diff(port, jax_out)
        print(f"{tile} {motion} k={k} t={t:.4f}: port vs Pallas max {max_d} LSB, exact {exact:.6f}, "
              f"hist {hist}; Pallas vs golden max {_diff(jax_out, golden)[0]} LSB")
        assert max_d <= bound


def test_port_golden_is_the_jax_golden():
    """The port's numpy golden is a faithful copy of the JAX package's."""
    a, b, tiles = _case(13, (8, 32), (24, 96), "varying")
    flow = _dense(tiles, (8, 32))
    for k, t in ((4, 0.5), (8, 0.3)):
        np.testing.assert_array_equal(
            pref.soft_warp_blend_ref(a, b, flow, t, (8, 32), rng=RNG, k=k),
            SW.soft_warp_blend_ref(a, b, flow, t, (8, 32), rng=RNG, k=k),
        )


@pytest.mark.parametrize("t", [0.25, 0.5])
def test_zero_motion_is_crossfade(t):
    rng = np.random.default_rng(14)
    a = rng.integers(0, 256, (16, 128, 4), np.uint8)
    b = rng.integers(0, 256, (16, 128, 4), np.uint8)
    port = _port(a, b, np.zeros((2, 4, 2), np.float32), t, (8, 32), 4)
    expect = np.clip(np.round(a * (1.0 - t) + b.astype(np.float64) * t), 0, 255)
    assert np.abs(port.astype(np.float64) - expect).max() <= 1.0


def _bench_pair(pattern, h: int, w: int, shift: int):
    """The bench input at a small size: the gradient pattern with a white
    box, and the same rolled right by `shift` columns (bench.py:72-75)."""
    a = pattern(w, h)
    a[h // 4: h // 2, w // 4: w // 4 + 30, :3] = 255
    return a, np.roll(a, shift, axis=1)


@pytest.mark.parametrize("case", ["uniform-noise", "bench-flow"])
def test_plain_vs_xla_soft_twin(case, pattern):
    """The gate of bench.py:835-853 on the CPU: the XLA soft path fed the
    same tile motion, densified (its K is WARP_K = 8 and its range 48), on
    uniform motion over noise and on the bench pair with the port's own
    flow_tiles_fast motion, as the bench feeds it."""
    from nu_scaler_tpu_torch.ops import interpolate as pinterp

    if case == "uniform-noise":
        tile = (8, 32)
        a, b, tiles = _case(15, tile, (32, 256), "uniform")
        a[..., 3] = b[..., 3] = 255
    else:
        tile = pinterp.WARP_TILE
        a, b = _bench_pair(pattern, 64, 256, 5)
        tiles = pinterp.flow_tiles_fast(torch.from_numpy(a), torch.from_numpy(b), tile).numpy()
    for t in (0.5, 1.0 / 3.0):
        port = _port(a, b, tiles, t, tile, jinterp.WARP_K, rng=jinterp.WARP_RANGE)
        twin = np.asarray(jinterp.warp_blend_fast(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(_dense(tiles, tile)), t,
            tile=tile, overlap=True, pallas_ok=False,
        ))
        p = psnr(port[..., :3], twin[..., :3])
        print(f"{case} t={t:.4f}: port vs XLA soft twin {p:.2f} dB (RGB)")
        assert p >= 50.0


def test_candidates_tie_order():
    """hist_topk / candidates equal the JAX ones on fields with tied counts:
    descending count, ties by ascending bin; argmin takes the first."""
    rng = np.random.default_rng(16)
    side_rng = 4
    fields = [
        # every offset once: all counts tie
        np.stack(np.meshgrid(np.arange(-2, 3), np.arange(-2, 3)), -1).astype(np.float32) + 0.25,
        # two offsets, six tiles each, plus singles
        np.array([[[1.5, 0.5]] * 6 + [[-1.5, 2.5]] * 6 + [[0.2, -3.7], [3.9, 3.9]]], np.float32),
        rng.integers(-side_rng, side_rng + 1, (6, 9, 2)).astype(np.float32) + 0.5,
    ]
    from nu_scaler_tpu.kernels.soft_warp_pallas import _candidates as jcandidates
    from nu_scaler_tpu.kernels.soft_warp_pallas import hist_topk as jhist_topk

    for field in fields:
        for k in (1, 4, 8):
            q = np.floor(field).astype(np.int32) + side_rng
            side = 2 * side_rng + 2
            np.testing.assert_array_equal(
                swc.hist_topk(torch.from_numpy(q), side, k).numpy(),
                np.asarray(jhist_topk(jnp.asarray(q), side, k)),
            )
            got = swc.candidates(torch.from_numpy(field), k, side_rng)
            want = jcandidates(jnp.asarray(field), k, side_rng)
            for g, w_ in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(shape=(20, 96)), "must tile"),
        (dict(k=9), "k must be in"),
        (dict(k=0), "k must be in"),
        (dict(tiles_shape=(3, 2, 2)), "tiles: expected"),
        (dict(dtype=torch.int16), "uint8"),
        (dict(b_shape=(24, 64)), "a \\(24, 96, 4\\)"),
    ],
    ids=["ragged", "k9", "k0", "tiles-shape", "dtype", "b-shape"],
)
def test_wrapper_validates_inputs(kwargs, match):
    h, w = kwargs.get("shape", (24, 96))
    a = torch.zeros((h, w, 4), dtype=kwargs.get("dtype", torch.uint8))
    bh, bw = kwargs.get("b_shape", (h, w))
    b = torch.zeros((bh, bw, 4), dtype=torch.uint8)
    tiles = torch.zeros(kwargs.get("tiles_shape", (h // 8, w // 32, 2)), dtype=torch.float32)
    with pytest.raises((TypeError, ValueError), match=match):
        swc.soft_warp_blend(a, b, tiles, 0.5, (8, 32), rng=RNG, k=kwargs.get("k", 4))


@pytest.mark.parametrize("tw", [12, 32, 64, 128], ids=["edge12", "tw32", "tw64", "tw128"])
def test_cell_column_from_the_reciprocal(tw):
    """The kernel's cell column (c + tw/2) / tw: trunc(f32(n) · reciprocal(tw))
    in f32 is off by at most one below 2^23, so one correction step each way
    (csrc/soft_warp.cu div_small) gives n // tw; checked for every n the
    kernel can meet (every column of every width it takes, and the width)."""
    inv = swc.reciprocal(tw)
    assert inv == float(np.float32(1.0 / tw))
    n = np.arange(swc.MAX_WIDTH + tw, dtype=np.int64)
    q = np.trunc(n.astype(np.float32) * np.float32(inv)).astype(np.int64)
    assert np.abs(q - n // tw).max() <= 1
    q = q + ((q + 1) * tw <= n)
    q = q - (q * tw > n)
    np.testing.assert_array_equal(q, n // tw)


@pytest.mark.parametrize(
    "shape, tile",
    [((8, swc.MAX_WIDTH), (8, 128)), ((swc.MAX_CELL_ROWS * 8, 256), (8, 128))],
    ids=["width", "tile-rows"],
)
def test_wrapper_refuses_what_the_kernel_cannot_index(shape, tile):
    """Widths from 2^22 and grids of 65535 tile rows: the kernel's limits."""
    h, w = shape
    a = torch.empty((h, w, 4), dtype=torch.uint8, device="meta")
    tiles = torch.empty((h // tile[0], w // tile[1], 2), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="the kernel takes widths below"):
        swc.check_inputs(a, a, tiles, tile, 4)
    smaller = (h, w - tile[1]) if w >= swc.MAX_WIDTH else (h - tile[0], w)
    a = torch.empty((*smaller, 4), dtype=torch.uint8, device="meta")
    tiles = torch.empty((smaller[0] // tile[0], smaller[1] // tile[1], 2), dtype=torch.float32, device="meta")
    swc.check_inputs(a, a, tiles, tile, 4)


def test_cpu_path_never_builds_or_counts(monkeypatch):
    """CPU tensors run the plain version: no build, no launch counted; the
    launcher refuses CPU tensors before it builds anything."""
    from nu_scaler_tpu_torch.kernels import _build

    def _no_build(*_):  # pragma: no cover - only fires on regression
        raise AssertionError("the CPU path must not build the CUDA kernel")

    monkeypatch.setattr(_build, "load_library", _no_build)
    swc.reset_launches()
    a, b, tiles = _case(17, (8, 32), (24, 96), "varying")
    _port(a, b, tiles, 0.5, (8, 32), 4)
    assert swc.launches == {"soft_warp_blend": 0}
    frames = swc.frame_inputs(torch.from_numpy(tiles), 0.5, 4, RNG)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        swc._launch(torch.from_numpy(a), torch.from_numpy(b), frames, swc.pack_inputs(frames),
                    (8, 32), 4)


def test_frame_inputs_follow_the_jax_front_end():
    """sign·tiles clipped to ±rng in fp32 (A: −t, B: 1 − t) and the weights
    1 − t, t, as soft_warp_pallas.py:904-957 forms them."""
    tiles = np.array([[[7.9, -2.2], [-9.1, 0.7]]], np.float32)
    fa, fb = swc.frame_inputs(torch.from_numpy(tiles), 1.0 / 3.0, 4, RNG)
    t = np.float32(1.0 / 3.0)
    np.testing.assert_array_equal(fa.tiles.numpy(), np.clip(-t * tiles, -RNG, RNG))
    np.testing.assert_array_equal(fb.tiles.numpy(), np.clip((np.float32(1) - t) * tiles, -RNG, RNG))
    assert fa.weight == float(np.float32(1) - t) and fb.weight == float(t)
