"""Bilinear image resize of the port: the counterpart of
``jax.image.resize(x, shape, method="bilinear")``, which the JAX package's
learned tier uses for ESRGANLite's base and to bring a net's output and the
alpha plane to the target size (`nu_scaler_tpu/models/esrgan_lite.py:167,
1178-1179`).

That function is `scale_and_translate` with ``antialias=True``: per axis a
weight matrix [in, out] of the triangle kernel max(0, 1 − |x|), widened by
1/scale when the axis shrinks, evaluated in fp32 at the sample positions
(o + 0.5)/scale − 0.5. Taps outside the input are dropped and each output's
weights renormalised to sum to 1 (not clamped to the edge, as the resample
kernels' `filter_weights` are), and an output whose sample lies outside
[−0.5, in − 0.5] gets none. Only axes whose size changes are contracted.
The weights are cast to the input's dtype, and each axis's contraction
returns that dtype: for a bf16 input, each product is exact in fp32 and
each contraction's sum is rounded to bf16 once.

The contractions run as gathers and weighted sums in plain PyTorch (a
matrix per axis would be dense and mostly zeros): the JAX package computes
this in XLA, in no Pallas kernel. With two axes changing, they run in the
order JAX's einsum picks: the cheaper first contraction by operation count
(opt_einsum's "optimal" path), the earlier axis on a tie.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_weights", "image_resize"]


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The fp32 weight matrix [in_size, out_size] of one axis, in the fp32
    operations of `jax._src.image.scale.compute_weight_mat` (triangle
    kernel, antialias, no translation)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The matrix's nonzero taps per output, in ascending input order:
    (indices int64 [K, out], fp32 weights [K, out]), K the most any output
    has; a missing tap reads input 0 with weight 0."""
    w = resize_weights(in_size, out_size)
    nz = w != 0
    k = max(1, int(nz.sum(axis=0).max()))
    idx = np.zeros((k, out_size), np.int64)
    wt = np.zeros((k, out_size), np.float32)
    for o in range(out_size):
        rows = np.nonzero(nz[:, o])[0]
        idx[: rows.size, o] = rows
        wt[: rows.size, o] = w[rows, o]
    return idx, wt


def _contract(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Resize `x` along `dim` to `out_size`: Σ_k w[k, o] · x[idx[k, o]] with
    the weights in x's dtype, the sum in fp32, one rounding to x's dtype."""
    idx, wt = _taps(x.shape[dim], out_size)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w = torch.from_numpy(wt).to(x.device).to(x.dtype).float()
    index = torch.from_numpy(idx).to(x.device)
    xf = x.float()
    acc = None
    for k in range(idx.shape[0]):
        term = xf.index_select(dim, index[k]) * w[k].reshape(shape)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def _order(in_shape: tuple, out_shape: tuple, dims: list[int]) -> list[int]:
    """The axes in JAX's order of contraction (two axes: the cheaper first
    contraction, by the product of the index sizes it spans; the earlier
    axis on a tie)."""
    if len(dims) != 2:
        return dims

    def cost(first: int, second: int) -> int:
        mid = list(in_shape)
        c1 = int(np.prod(mid)) * out_shape[first]
        mid[first] = out_shape[first]
        return c1 + int(np.prod(mid)) * out_shape[second]

    a, b = dims
    return [b, a] if cost(b, a) < cost(a, b) else [a, b]


def image_resize(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, method="bilinear")`` for an fp32 or bf16
    tensor of any rank: the axes whose size changes are contracted, in
    JAX's order; the result has x's dtype and device."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} must have x's rank {x.dim()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected an fp32 or bf16 tensor, got {x.dtype}")
    dims = [d for d in range(x.dim()) if x.shape[d] != shape[d]]
    for d in _order(tuple(x.shape), shape, dims):
        x = _contract(x, d, shape[d])
    return x
