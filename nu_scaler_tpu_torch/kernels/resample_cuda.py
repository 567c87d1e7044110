"""Wrappers of the fused resample kernel (`csrc/resample_fused.cu`) and the
two-launch resample (`csrc/resample_twopass.cu`), their plain PyTorch
versions, and the tap tables they share.

Three wrappers of one kernel template, and one of two kernels:

* `resample_fused`          u8 [H,W,4]   → [OH,OW,4]      (replaces
  `nu_scaler_tpu/kernels/resample_pallas.py:268` make_pallas_fused)
* `resample_fused_batched`  u8 [N,H,W,4] → [N,OH,OW,4]    (replaces
  `resample_pallas.py:139` make_pallas_fused_batched)
* `resample_fused_blend`    cur [H,W,4], prev [OH,OW,4] → (cur_up, *mids)
  (replaces `resample_pallas.py:371` make_pallas_fused_blend)
* `resample_twopass`        u8 [H,W,4] or [N,H,W,4] → [..,OH,OW,4] in two
  launches, the fp32 intermediate in device memory (replaces
  `resample_pallas.py:65` make_pallas_resampler), on its own dense bands
  (`twopass_bands`); the same bytes as `resample_fused`, whose plain version
  it shares

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. The resample has no learned weights: the
per-axis filter matrices are its parameters. `taps_from_matrix` turns one
axis's dense [O, I] matrix into the kernel's compact table, and
`dense_from_taps` turns it back, so the kernel and the plain version read the
very same weight values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device
from nu_scaler_tpu_torch.utils.tracing import span

# Launches per wrapper since the last `reset_launches()`; a wrapper adds one
# where it launches its kernel and nowhere else.
launches = {"resample_fused": 0, "resample_fused_batched": 0, "resample_fused_blend": 0,
            "resample_twopass": 0}

# Hopper: 227 KB of shared memory per block (opt-in above 48 KB).
SMEM_LIMIT = 232448
RUN, GROUP = 8, 4  # the kernel's work items: 8 output rows (vertical), 4 output columns (horizontal)
# output tiles (tile_h, tile_w) the planner tries, largest first
TILES = ((64, 128), (32, 128), (64, 64), (32, 64), (16, 64), (16, 32), (8, 32), (8, 16), (8, 8),
         (8, 4))
TILE_H, TILE_W = TILES[0]
MAX_TS = 2


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# tap tables
# ---------------------------------------------------------------------------


def taps_from_matrix(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense [O, I] axis matrix → (first int32 [O], weights f32 [O, K]).

    Row o reads inputs first[o] .. first[o] + K - 1, where K is the widest
    nonzero band of any row. `first` is moved left where the band would run
    past the last input, so every tap index is in range; the extra taps get
    zero weight. Clamped edge taps make every row's band contiguous.
    """
    w = np.asarray(w, dtype=np.float32)
    out_size, in_size = w.shape
    nz = w != 0
    has = nz.any(axis=1)
    lo = np.where(has, nz.argmax(axis=1), 0)
    hi = np.where(has, in_size - 1 - nz[:, ::-1].argmax(axis=1), 0)
    k = int(max(1, (hi - lo + 1).max()))
    first = np.minimum(lo, in_size - k).astype(np.int32)
    idx = first[:, None] + np.arange(k)[None, :]
    weights = np.take_along_axis(w, idx, axis=1).astype(np.float32)
    return first, np.ascontiguousarray(weights)


def dense_from_taps(first: np.ndarray, weights: np.ndarray, in_size: int) -> np.ndarray:
    """Inverse of `taps_from_matrix`: the dense [O, I] float32 matrix."""
    out_size, k = weights.shape
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.repeat(np.arange(out_size), k)
    cols = (first[:, None] + np.arange(k)[None, :]).ravel()
    mat[rows, cols] = weights.ravel()
    return mat


def footprint(first: np.ndarray, k: int, tile: int) -> int:
    """Largest input span that one tile of `tile` consecutive outputs reads."""
    starts = first[::tile]
    last = np.minimum(np.arange(tile - 1, len(first) + tile - 1, tile), len(first) - 1)
    return int((first[last] + k - starts).max())


class TilePlan(NamedTuple):
    """The kernel's tiling: tile_h × tile_w outputs a tile, the largest input
    footprint fr × fc of any tile, the widest input window wv of a run of
    `RUN` output rows and wh of a group of `GROUP` output columns, the
    footprint buffers (2: the next tile loads while this one computes) and
    the shared memory they add up to."""

    tile_h: int
    tile_w: int
    fr: int
    fc: int
    wv: int
    wh: int
    nbuf: int
    smem: int


def smem_bytes(tile_h: int, tile_w: int, fr: int, fc: int, wv: int, wh: int, nbuf: int) -> int:
    """Shared memory of the kernel's layout (`make_plan` in
    csrc/resample_fused.cu): nbuf u8 footprints of fr rows × fcw pixels
    (from the 16-byte-aligned column at or below the first), two buffers of
    the tile's band tables (`band_tables`: the vertical weights [tile_h / RUN,
    wv, RUN] and window starts, the horizontal weights [wh, tile_w / GROUP]
    float4 and window starts, the starts padded to 4), and the fp32
    intermediate, column-major [fc, tile_h + 1] (float4 a pixel)."""
    def pad4(n):
        return (n + 3) // 4 * 4

    fcw = (fc + 3 + 3) // 4 * 4
    tables = (tile_h // RUN * wv * RUN * 4 + pad4(tile_h // RUN) * 4
              + wh * (tile_w // GROUP) * 16 + pad4(tile_w // GROUP) * 4)
    return nbuf * fr * fcw * 4 + 2 * tables + fc * (tile_h + 1) * 16


def band_tables(first: np.ndarray, taps: np.ndarray, tile: int, run: int,
                window: int) -> tuple[np.ndarray, np.ndarray]:
    """One axis's taps as the kernel's dense bands, per tile of `tile`
    outputs: (weights f32 [tiles, tile / run, window, run], starts int32
    [tiles, tile / run padded to 4]). Run b of tile i covers outputs
    i·tile + b·run + e (e < run); its window starts at input
    first[i·tile + b·run], given relative to the tile's first input
    first[i·tile]; weights[i, b, j, e] is the tap of output o on input
    start + j (0 outside o's band, and for outputs past the axis)."""
    n_out, k = taps.shape
    n_tiles = -(-n_out // tile)
    runs = tile // run
    ti = np.arange(n_tiles)[:, None, None]
    o = ti * tile + np.arange(runs)[None, :, None] * run + np.arange(run)[None, None, :]
    valid = o < n_out
    oc = np.minimum(o, n_out - 1)
    run0 = first[np.minimum(o[:, :, :1], n_out - 1)]  # [tiles, runs, 1]
    k_idx = np.arange(window)[None, None, :, None] + run0[..., None] - first[oc][:, :, None, :]
    ok = valid[:, :, None, :] & (k_idx >= 0) & (k_idx < k)
    w = np.where(ok, taps[oc[:, :, None, :], np.clip(k_idx, 0, k - 1)], 0.0).astype(np.float32)
    starts = np.zeros((n_tiles, (runs + 3) // 4 * 4), np.int32)
    starts[:, :runs] = run0[..., 0] - first[np.minimum(ti[:, :, 0] * tile, n_out - 1)]
    return np.ascontiguousarray(w), starts


class TwoPassBands(NamedTuple):
    """The two-call kernel's dense bands (`twopass_bands`), on a device: the
    vertical weights fp32 [ceil(OH / RUN), wv, RUN] and their window wv; the
    horizontal weights fp32 [wh, ceil(OW / GROUP), GROUP] and their window
    wh."""

    dv: torch.Tensor
    wv: int
    dh: torch.Tensor
    wh: int


def twopass_bands(first: np.ndarray, taps: np.ndarray, run: int) -> tuple[np.ndarray, int]:
    """One axis's taps as the two-call kernel's dense bands: for each run of
    `run` outputs, the weights of the run's window of inputs from
    first[run · i] for each of its outputs, f32 [runs, window, run] (0
    outside an output's band and for outputs past the axis), and the window,
    the widest of any run (`footprint`)."""
    window = footprint(first, taps.shape[1], run)
    w, _ = band_tables(first, taps, run, run, window)
    return np.ascontiguousarray(w[:, 0]), window


def tile_plan(first_v, kv: int, first_h, kh: int, tile=None) -> TilePlan:
    """The kernel's tiling for these tap tables: the first of `TILES` (or the
    given `tile`) whose shared memory lets two blocks share an SM with two
    footprint buffers, else with one, else one block with two, else with one."""
    wv = footprint(first_v, kv, RUN)
    wh = footprint(first_h, kh, GROUP)
    fits = []
    for th, tw in (TILES if tile is None else (tuple(tile),)):
        if th % RUN or tw % GROUP:
            raise ValueError(f"tile {th}x{tw}: tile_h must be a multiple of {RUN}, tile_w of {GROUP}")
        fr = footprint(first_v, kv, th)
        fc = footprint(first_h, kh, tw)
        for nbuf in (2, 1):
            fits.append(TilePlan(th, tw, fr, fc, wv, wh, nbuf, smem_bytes(th, tw, fr, fc, wv, wh, nbuf)))
    for limit in (SMEM_LIMIT // 2, SMEM_LIMIT):
        for plan in fits:
            if plan.smem <= limit:
                return plan
    smallest = min(fits, key=lambda t: t.smem)
    raise ValueError(
        f"resample footprint {smallest.fr}x{smallest.fc} does not fit in shared memory "
        f"({smallest.smem} > {SMEM_LIMIT} bytes)"
    )


class ResamplePlan:
    """Both axes' tap tables on one device, with the kernel's tiling."""

    def __init__(self, wv: np.ndarray, wh: np.ndarray, device: torch.device) -> None:
        self.device = resolve_device(device)
        self.out_h, self.in_h = wv.shape
        self.out_w, self.in_w = wh.shape
        first_v, taps_v = taps_from_matrix(wv)
        first_h, taps_h = taps_from_matrix(wh)
        if np.any(np.diff(first_v) < 0) or np.any(np.diff(first_h) < 0):
            raise ValueError("tap tables need a non-decreasing first tap")
        self.kv, self.kh = taps_v.shape[1], taps_h.shape[1]
        # nonzero taps: the multiply-adds this resample really needs
        self.nnz_v = int(np.count_nonzero(taps_v))
        self.nnz_h = int(np.count_nonzero(taps_h))
        self._np = (first_v, taps_v, first_h, taps_h)
        # the kernel's tiling and band tables; the plain version on the CPU
        # needs neither
        self.tiles = self.bands = None
        if self.device.type == "cuda":
            self.tiles = tile_plan(first_v, self.kv, first_h, self.kh)
            self.bands = self.band_tables(self.tiles)
        self.first_v = torch.from_numpy(first_v).to(self.device)
        self.first_h = torch.from_numpy(first_h).to(self.device)

    def band_tables(self, tp: TilePlan) -> tuple[torch.Tensor, ...]:
        """The kernel's band tables for the tiling `tp`, on the plan's device:
        (vertical weights, starts, horizontal weights [tiles_x, wh, tile_w /
        GROUP, GROUP], starts)."""
        first_v, taps_v, first_h, taps_h = self._np
        dv, vs = band_tables(first_v, taps_v, tp.tile_h, RUN, tp.wv)
        dh, hs = band_tables(first_h, taps_h, tp.tile_w, GROUP, tp.wh)
        dh = dh.transpose(0, 2, 1, 3)  # [tiles_x, wh, groups, GROUP]: a float4 per group
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in (dv, vs, dh, hs))

    @functools.cached_property
    def twopass(self) -> TwoPassBands:
        """The two-call kernel's dense bands on the plan's device, built at
        its first launch (the horizontal ones [wh, groups, GROUP]: a float4
        per group, neighbouring groups side by side)."""
        first_v, taps_v, first_h, taps_h = self._np
        dv, wv = twopass_bands(first_v, taps_v, RUN)
        dh, wh = twopass_bands(first_h, taps_h, GROUP)
        dh = np.ascontiguousarray(dh.transpose(1, 0, 2))
        return TwoPassBands(torch.from_numpy(dv).to(self.device), wv,
                            torch.from_numpy(dh).to(self.device), wh)

    def tiling(self, tile: tuple[int, int]) -> tuple[TilePlan, tuple[torch.Tensor, ...]]:
        """Another tiling than the planned one, with its band tables, for
        `_launch` (to time the kernel's tiles against each other)."""
        first_v, _, first_h, _ = self._np
        tp = tile_plan(first_v, self.kv, first_h, self.kh, tile)
        return tp, self.band_tables(tp)

    @functools.cached_property
    def dense_v(self) -> torch.Tensor:
        first_v, taps_v, _, _ = self._np
        return torch.from_numpy(dense_from_taps(first_v, taps_v, self.in_h)).to(self.device)

    @functools.cached_property
    def dense_h(self) -> torch.Tensor:
        _, _, first_h, taps_h = self._np
        return torch.from_numpy(dense_from_taps(first_h, taps_h, self.in_w)).to(self.device)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def resample_plain(src: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """u8 [..., H, W, 4] → u8 [..., OH, OW, 4]: two fp32 matmuls on the dense
    matrices, then trunc(clip(·, 0, 255)). On a card this needs
    `torch.backends.cuda.matmul.fp32_precision` "ieee" (PyTorch's default
    "none" is that too).

    Both products are plain 2-D matmuls (no broadcast batch, which would
    materialize the dense matrix once per row)."""
    lead = src.shape[:-3]
    x = src.reshape(-1, plan.in_h, plan.in_w * 4).to(torch.float32)
    n = x.shape[0]
    # vertical: [OH, H] @ [H, n*W*4]
    tmp = plan.dense_v @ x.permute(1, 0, 2).reshape(plan.in_h, -1)
    # horizontal: [n*OH*4, W] @ [W, OW]
    tmp = tmp.reshape(plan.out_h, n, plan.in_w, 4).permute(1, 0, 3, 2).reshape(-1, plan.in_w)
    out = (tmp @ plan.dense_h.T).reshape(n, plan.out_h, 4, plan.out_w).permute(0, 1, 3, 2)
    out = torch.trunc(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)
    return out.reshape(*lead, plan.out_h, plan.out_w, 4)


def mix_plain(prev: torch.Tensor, cur: torch.Tensor, ts: Sequence[float]) -> list[torch.Tensor]:
    """clip(round(prev + (cur − prev)·t), 0, 255) for each t: two separately
    rounded fp32 operations, rounded half to even."""
    a = prev.to(torch.float32)
    b = cur.to(torch.float32)
    mids = []
    for t in ts:
        tt = torch.tensor(t, dtype=torch.float32, device=a.device)
        mids.append(torch.clamp(torch.round(a + (b - a) * tt), 0.0, 255.0).to(torch.uint8))
    return mids


def resample_blend_plain(
    src: torch.Tensor, prev: torch.Tensor, plan: ResamplePlan, ts: Sequence[float]
) -> tuple[torch.Tensor, ...]:
    cur = resample_plain(src, plan)
    return (cur, *mix_plain(prev, cur, ts))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_u8(x: torch.Tensor, shape: tuple, what: str, plan: ResamplePlan) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(x.shape)}")
    if x.device != plan.device:
        raise ValueError(f"{what}: tensor on {x.device}, plan on {plan.device}")


def _times(ts: Sequence[float]) -> tuple[float, ...]:
    out = tuple(float(np.float32(t)) for t in ts)
    if not 1 <= len(out) <= MAX_TS:
        raise ValueError(f"the blend epilogue takes 1 to {MAX_TS} times, got {len(out)}")
    return out


def _launch(src: torch.Tensor, n: int, plan: ResamplePlan, prev=None, ts=(), tiling=None) -> list:
    """One launch of the kernel over n frames, on the plan's tiling or on
    `tiling` (from `plan.tiling`); returns [dst, *mids]."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {src.device}")
    tp, bands = (plan.tiles, plan.bands) if tiling is None else tiling
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("resample_fused")
    src = src.contiguous()
    shape = (n, plan.out_h, plan.out_w, 4) if src.dim() == 4 else (plan.out_h, plan.out_w, 4)
    outs = [torch.empty(shape, dtype=torch.uint8, device=src.device) for _ in range(1 + len(ts))]
    mids = [o.data_ptr() for o in outs[1:]] + [None] * (MAX_TS - len(ts))
    t = list(ts) + [0.0] * (MAX_TS - len(ts))
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nu_resample_fused(
        src.device.index or 0, src.data_ptr(), n, plan.in_h, plan.in_w,
        plan.first_v.data_ptr(), plan.kv, plan.first_h.data_ptr(), plan.kh,
        plan.out_h, plan.out_w, tp.tile_h, tp.tile_w, tp.fr, tp.fc, tp.wv, tp.wh, tp.nbuf, tp.smem,
        *(b.data_ptr() for b in bands),
        None if prev is None else prev.contiguous().data_ptr(), len(ts), t[0], t[1],
        outs[0].data_ptr(), mids[0], mids[1], stream,
    )
    if err != 0:
        raise RuntimeError(
            f"resample_fused launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})"
        )
    return outs


def resample_fused(src: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """u8 [H,W,4] → u8 [OH,OW,4]."""
    _check_u8(src, (plan.in_h, plan.in_w, 4), "src", plan)
    if src.device.type == "cpu":
        return resample_plain(src, plan)
    with span("nu.kernels.resample_fused"):
        out = _launch(src, 1, plan)[0]
    launches["resample_fused"] += 1
    return out


def resample_fused_batched(src: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """u8 [N,H,W,4] → u8 [N,OH,OW,4] in one launch (batch = grid z)."""
    if src.dim() != 4:
        raise ValueError(f"src: expected [N, H, W, 4], got {tuple(src.shape)}")
    n = src.shape[0]
    _check_u8(src, (n, plan.in_h, plan.in_w, 4), "src", plan)
    if src.device.type == "cpu":
        return resample_plain(src, plan)
    out = _launch(src, n, plan)[0]
    launches["resample_fused_batched"] += 1
    return out


def resample_fused_blend(
    src: torch.Tensor, prev: torch.Tensor, plan: ResamplePlan, ts: Sequence[float]
) -> tuple[torch.Tensor, ...]:
    """cur u8 [H,W,4], prev u8 [OH,OW,4] → (cur_up, mid_t for each t): the
    mix is taken on the truncated u8 upscale."""
    ts = _times(ts)
    _check_u8(src, (plan.in_h, plan.in_w, 4), "src", plan)
    _check_u8(prev, (plan.out_h, plan.out_w, 4), "prev", plan)
    if src.device.type == "cpu":
        return resample_blend_plain(src, prev, plan, ts)
    with span("nu.kernels.resample_fused"):
        outs = _launch(src, 1, plan, prev, ts)
    launches["resample_fused_blend"] += 1
    return tuple(outs)


def _launch_vert(src: torch.Tensor, n: int, plan: ResamplePlan) -> torch.Tensor:
    """Launch 1 of the two-pass kernel: u8 [n, H, W, 4] → fp32 [n, OH, W, 4]."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {src.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("resample_twopass")
    src = src.contiguous()
    mid = torch.empty((n, plan.out_h, plan.in_w, 4), dtype=torch.float32, device=src.device)
    bands = plan.twopass
    err = lib.nu_resample_vert(
        src.device.index or 0, src.data_ptr(), n, plan.in_h, plan.in_w,
        plan.first_v.data_ptr(), bands.dv.data_ptr(), bands.wv, plan.out_h,
        mid.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"resample_twopass vertical launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})"
        )
    return mid


def _launch_horiz(mid: torch.Tensor, n: int, plan: ResamplePlan) -> torch.Tensor:
    """Launch 2 of the two-pass kernel: fp32 [n, OH, W, 4] → u8 [n, OH, OW, 4]."""
    if mid.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {mid.device}")
    from nu_scaler_tpu_torch.kernels import _build

    lib = _build.load_library("resample_twopass")
    if mid.dtype != torch.float32 or tuple(mid.shape) != (n, plan.out_h, plan.in_w, 4):
        raise ValueError(f"mid: expected fp32 [{n}, {plan.out_h}, {plan.in_w}, 4], "
                         f"got {mid.dtype} {tuple(mid.shape)}")
    mid = mid.contiguous()
    dst = torch.empty((n, plan.out_h, plan.out_w, 4), dtype=torch.uint8, device=mid.device)
    bands = plan.twopass
    err = lib.nu_resample_horiz(
        mid.device.index or 0, mid.data_ptr(), n, plan.out_h, plan.in_w,
        plan.first_h.data_ptr(), bands.dh.data_ptr(), bands.wh, plan.out_w,
        dst.data_ptr(), torch.cuda.current_stream(mid.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"resample_twopass horizontal launch failed: {lib.nu_cuda_error_string(err).decode()} ({err})"
        )
    return dst


def resample_twopass(src: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """u8 [H,W,4] → u8 [OH,OW,4], or a batch [N,H,W,4] → [N,OH,OW,4], in two
    launches (vertical, then horizontal; batch = grid z); counts one launch
    for each."""
    single = src.dim() == 3
    n = 1 if single else src.shape[0]
    _check_u8(src, (plan.in_h, plan.in_w, 4) if single else (n, plan.in_h, plan.in_w, 4),
              "src", plan)
    if src.device.type == "cpu":
        return resample_plain(src, plan)
    mid = _launch_vert(src, n, plan)
    launches["resample_twopass"] += 1
    out = _launch_horiz(mid, n, plan)
    launches["resample_twopass"] += 1
    return out[0] if single else out
