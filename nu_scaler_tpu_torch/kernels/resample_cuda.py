"""Wrappers of the fused resample kernel (`csrc/resample_fused.cu`), their
plain PyTorch versions, and the tap tables both share.

Three wrappers, one kernel template:

* `resample_fused`          u8 [H,W,4]   → [OH,OW,4]      (replaces
  `nu_scaler_tpu/kernels/resample_pallas.py:268` make_pallas_fused)
* `resample_fused_batched`  u8 [N,H,W,4] → [N,OH,OW,4]    (replaces
  `resample_pallas.py:139` make_pallas_fused_batched)
* `resample_fused_blend`    cur [H,W,4], prev [OH,OW,4] → (cur_up, *mids)
  (replaces `resample_pallas.py:371` make_pallas_fused_blend)

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. The resample has no learned weights: the
per-axis filter matrices are its parameters. `taps_from_matrix` turns one
axis's dense [O, I] matrix into the kernel's compact table, and
`dense_from_taps` turns it back, so the kernel and the plain version read the
very same weight values.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from nu_scaler_tpu_torch.device import resolve_device

# Launches per wrapper since the last `reset_launches()`; a wrapper adds one
# where it launches its kernel and nowhere else.
launches = {"resample_fused": 0, "resample_fused_batched": 0, "resample_fused_blend": 0}

# Hopper: 227 KB of shared memory per block (opt-in above 48 KB).
SMEM_LIMIT = 232448
TILE_H, TILE_W = 32, 64
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


def tile_plan(first_v, kv: int, first_h, kh: int) -> tuple[int, int, int]:
    """(tile_h, tile_w, shared-memory bytes) for the kernel: the default
    32×64 output tile, halved until the fp32 intermediate [tile_h, fc] and the
    u8 footprint [fr, fc] fit in shared memory."""
    th, tw = TILE_H, TILE_W
    while True:
        fr = footprint(first_v, kv, th)
        fc = footprint(first_h, kh, tw)
        smem = th * fc * 16 + fr * fc * 4
        if smem <= SMEM_LIMIT:
            return th, tw, smem
        if tw > 1 and tw >= th:
            tw //= 2
        elif th > 1:
            th //= 2
        else:
            raise ValueError(
                f"resample footprint {fr}x{fc} does not fit in shared memory "
                f"({smem} > {SMEM_LIMIT} bytes)"
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
        # the kernel's tiling; the plain version on the CPU needs none
        self.tile_h = self.tile_w = self.smem_bytes = None
        if self.device.type == "cuda":
            self.tile_h, self.tile_w, self.smem_bytes = tile_plan(
                first_v, self.kv, first_h, self.kh
            )
        self._np = (first_v, taps_v, first_h, taps_h)
        self.first_v = torch.from_numpy(first_v).to(self.device)
        self.taps_v = torch.from_numpy(taps_v).to(self.device)
        self.first_h = torch.from_numpy(first_h).to(self.device)
        self.taps_h = torch.from_numpy(taps_h).to(self.device)

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
    `torch.backends.cuda.matmul.allow_tf32` False (PyTorch's default).

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


def _launch(src: torch.Tensor, n: int, plan: ResamplePlan, prev=None, ts=()) -> list:
    """One launch of the kernel over n frames; returns [dst, *mids]."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel needs a CUDA tensor, got {src.device}")
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
        plan.first_v.data_ptr(), plan.taps_v.data_ptr(), plan.kv,
        plan.first_h.data_ptr(), plan.taps_h.data_ptr(), plan.kh,
        plan.out_h, plan.out_w, plan.tile_h, plan.tile_w, plan.smem_bytes,
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
    outs = _launch(src, 1, plan, prev, ts)
    launches["resample_fused_blend"] += 1
    return tuple(outs)
