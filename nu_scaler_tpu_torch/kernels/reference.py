"""Numpy golden references for the port's resample, interpolation (flow,
warp / blend), soft-warp and FSR paths.

The port's own copy of the goldens of the JAX package (it imports nothing
from that package). They encode the semantics of the reference
implementation's shaders:

* Frames are RGBA uint8 arrays of shape [H, W, 4].
* "WGSL trunc packing": u8 = trunc(clamp(v, 0, 1) * 255).
* "unorm packing": round-to-nearest, used by the cross-fade output.
* nearest and bilinear keep the WGSL top-left alignment
  (src = dst * in / out); bicubic, Lanczos, Mitchell and area use the
  center-aligned separable convention src = (dst + 0.5) * in / out - 0.5,
  clamp-to-edge, rows normalized to 1.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# u8 <-> float packing
# ---------------------------------------------------------------------------


def unpack_u8(img_u8: np.ndarray) -> np.ndarray:
    """u8 -> f32 in [0,1]; WGSL `unpack_rgba8` (upscale/mod.rs:220-226)."""
    return img_u8.astype(np.float32) / 255.0


def pack_u8_trunc(img_f: np.ndarray) -> np.ndarray:
    """f32 [0,1] -> u8 by truncation; WGSL `pack_rgba8` (upscale/mod.rs:227-234).

    `u32(x)` in WGSL truncates toward zero after clamp.
    """
    return np.trunc(np.clip(img_f, 0.0, 1.0) * 255.0).astype(np.uint8)


def pack_u8_round(img_f: np.ndarray) -> np.ndarray:
    """f32 [0,1] -> u8 round-to-nearest; rgba8unorm textureStore semantics."""
    return np.clip(np.round(img_f * 255.0), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Resampling kernels
# ---------------------------------------------------------------------------


def nearest_ref(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbor upscale, WGSL semantics.

    src = (dst * in) // out — integer math, floor division
    (NN_UPSCALE_SHADER, upscale/mod.rs:196-205). Pure u8 gather, no float
    round-trip.
    """
    in_h, in_w = img.shape[:2]
    ys = (np.arange(out_h, dtype=np.uint64) * in_h) // out_h
    xs = (np.arange(out_w, dtype=np.uint64) * in_w) // out_w
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def bilinear_ref(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear upscale, WGSL semantics (BILINEAR_UPSCALE_SHADER,
    upscale/mod.rs:236-262).

    fx = x * in/out (top-left aligned, NOT half-pixel-center), x0 = trunc(fx),
    x1 = min(x0+1, in-1), lerp with dx = fx - x0 on f32 values in [0,1],
    trunc-packed back to u8.
    """
    in_h, in_w = img_u8.shape[:2]
    f = unpack_u8(img_u8)

    fx = np.arange(out_w, dtype=np.float32) * np.float32(in_w) / np.float32(out_w)
    fy = np.arange(out_h, dtype=np.float32) * np.float32(in_h) / np.float32(out_h)
    x0 = fx.astype(np.int64)
    y0 = fy.astype(np.int64)
    x1 = np.minimum(x0 + 1, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    dx = (fx - x0.astype(np.float32))[None, :, None]
    dy = (fy - y0.astype(np.float32))[:, None, None]

    c00 = f[y0][:, x0]
    c10 = f[y0][:, x1]
    c01 = f[y1][:, x0]
    c11 = f[y1][:, x1]
    c0 = c00 + dx * (c10 - c00)  # mix(c00, c10, dx)
    c1 = c01 + dx * (c11 - c01)
    c = c0 + dy * (c1 - c0)
    return pack_u8_trunc(c)


# --- separable filter kernels (G1 algorithm set, Nu_scale/src/upscale/common.rs:68-88)


def _kernel_bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Catmull-Rom (a=-0.5) cubic, the `image` crate's CatmullRom used for the
    legacy Bicubic tier (Nu_scale/src/upscale/common.rs:163-323)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _kernel_mitchell(x: np.ndarray, b: float = 1.0 / 3.0, c: float = 1.0 / 3.0) -> np.ndarray:
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    p1 = (12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)
    p2 = (-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x + (8 * b + 24 * c)
    return np.where(x < 1.0, p1, np.where(x < 2.0, p2, 0.0)) / 6.0


def _kernel_lanczos(x: np.ndarray, a: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


def _kernel_triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_FILTERS = {
    "bicubic": (_kernel_bicubic, 2.0),
    "mitchell": (_kernel_mitchell, 2.0),
    "lanczos2": (lambda x: _kernel_lanczos(x, 2), 2.0),
    "lanczos3": (lambda x: _kernel_lanczos(x, 3), 3.0),
    # center-aligned bilinear (texture-sampler convention); used for flow
    # upsampling, not exposed through the algorithm strings
    "bilinear_center": (_kernel_triangle, 1.0),
}


def nearest_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] 0/1 matrix with the WGSL NN mapping src=(dst*in)//out —
    lets nearest ride the same tap-table kernel as the filters."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    src = (np.arange(out_size, dtype=np.uint64) * in_size) // out_size
    mat[np.arange(out_size), src.astype(np.int64)] = 1.0
    return mat


def bilinear_weights_wgsl(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] 2-tap matrix with the WGSL bilinear convention: top-left
    aligned fx = dst*in/out (no half-pixel center), x1 clamped
    (upscale/mod.rs:245-252)."""
    fx = np.arange(out_size, dtype=np.float32) * np.float32(in_size) / np.float32(out_size)
    x0 = fx.astype(np.int64)
    x1 = np.minimum(x0 + 1, in_size - 1)
    dx = (fx - x0.astype(np.float32)).astype(np.float32)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(mat, (np.arange(out_size), x0), 1.0 - dx)
    np.add.at(mat, (np.arange(out_size), x1), dx)
    return mat


def filter_weights(in_size: int, out_size: int, algorithm: str) -> np.ndarray:
    """Dense [out_size, in_size] float32 weight matrix for one axis.

    Center-aligned: src = (dst + 0.5) * in/out - 0.5. When downscaling the
    kernel support is widened by the scale ratio (standard anti-aliased
    convention, matching the `image` crate / PIL). Edge taps clamp: out-of-range
    tap weight accumulates onto the clamped edge index. Rows normalized to 1.
    """
    if algorithm == "area":
        return _area_weights(in_size, out_size)
    if algorithm == "nearest":
        return nearest_weights(in_size, out_size)
    if algorithm == "bilinear":
        return bilinear_weights_wgsl(in_size, out_size)
    kern, support = _FILTERS[algorithm]
    scale = in_size / out_size
    # widen kernel when minifying
    fscale = max(scale, 1.0)
    r = support * fscale
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers - r).astype(np.int64) + 1
    ntaps = int(np.ceil(2 * r)) + 1
    taps = lo[:, None] + np.arange(ntaps)[None, :]  # [out, ntaps]
    w = kern((taps - centers[:, None]) / fscale)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(taps, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), ntaps), idx.ravel()), w.ravel())
    return mat.astype(np.float32)


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """Box/area weights: overlap of each output pixel's footprint with input
    pixels (the legacy `Area` tier)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        a, b = o * scale, (o + 1) * scale
        i0, i1 = int(np.floor(a)), min(int(np.ceil(b)), in_size)
        for i in range(i0, i1):
            mat[o, i] = min(b, i + 1) - max(a, i)
    mat /= mat.sum(axis=1, keepdims=True)
    return mat.astype(np.float32)


def separable_resample_ref(img_u8: np.ndarray, out_h: int, out_w: int, algorithm: str) -> np.ndarray:
    """Golden separable resample for bicubic/lanczos2/lanczos3/mitchell/area."""
    wv = filter_weights(img_u8.shape[0], out_h, algorithm).astype(np.float64)
    wh = filter_weights(img_u8.shape[1], out_w, algorithm).astype(np.float64)
    f = unpack_u8(img_u8).astype(np.float64)
    h, w, c = f.shape
    # BLAS GEMMs, not bare einsum: the naive einsum loop runs minutes per
    # 1080p→4K golden (~6e10 f64 MACs). f64 accumulation-order noise
    # (~1e-12 relative) is far below the trunc packing's own f32 cast.
    tmp = (wv @ f.reshape(h, w * c)).reshape(out_h, w, c)
    out = np.tensordot(tmp, wh, axes=([1], [1])).transpose(0, 2, 1)
    return pack_u8_trunc(np.ascontiguousarray(out).astype(np.float32))


# ---------------------------------------------------------------------------
# Interpolation pipeline kernels
# ---------------------------------------------------------------------------


def _sample_bilinear_clamp(img_f: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """textureSampleLevel with a bilinear, clamp-to-edge sampler.

    `xs`, `ys` are continuous pixel coordinates (texel centers at k+0.5), shape
    [H, W]. Matches wgpu sampler semantics used by warp_blend.wgsl:40-41.
    """
    h, w = img_f.shape[:2]
    # convert texel-center coordinates to sample positions
    fx = xs - 0.5
    fy = ys - 0.5
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    dx = (fx - x0)[..., None]
    dy = (fy - y0)[..., None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    c00 = img_f[y0c, x0c]
    c10 = img_f[y0c, x1c]
    c01 = img_f[y1c, x0c]
    c11 = img_f[y1c, x1c]
    c0 = c00 + dx * (c10 - c00)
    c1 = c01 + dx * (c11 - c01)
    return c0 + dy * (c1 - c0)


def warp_blend_ref(
    frame_a_u8: np.ndarray,
    frame_b_u8: np.ndarray,
    flow: np.ndarray,
    time_t: float,
) -> np.ndarray:
    """Motion-compensated blend; warp_blend.wgsl:29-46.

    Samples A at (pos+0.5) - t*flow, B at (pos+0.5) + (1-t)*flow with a
    bilinear clamp sampler, then mix(c0, c1, t), rgba8unorm (round) output.
    `flow` is [H, W, 2] pixel-delta (x, y).
    """
    h, w = frame_a_u8.shape[:2]
    a = unpack_u8(frame_a_u8)
    b = unpack_u8(frame_b_u8)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5, np.arange(h, dtype=np.float32) + 0.5)
    c0 = _sample_bilinear_clamp(a, gx - time_t * flow[..., 0], gy - time_t * flow[..., 1])
    c1 = _sample_bilinear_clamp(b, gx + (1.0 - time_t) * flow[..., 0], gy + (1.0 - time_t) * flow[..., 1])
    return pack_u8_round(c0 + (c1 - c0) * np.float32(time_t))


def gaussian_blur_ref(img_f: np.ndarray) -> np.ndarray:
    """Separable 5-tap Gaussian, weights 1-4-6-4-1 / 16, clamp-to-edge
    (gaussian_blur_h.wgsl:18-20, unrolled taps :33-51; then the V pass)."""
    w = np.array([1, 4, 6, 4, 1], dtype=np.float32) / 16.0
    h_, w_ = img_f.shape[:2]
    out = np.zeros_like(img_f)
    for k, wk in enumerate(w):
        xs = np.clip(np.arange(w_) + k - 2, 0, w_ - 1)
        out += wk * img_f[:, xs]
    out2 = np.zeros_like(out)
    for k, wk in enumerate(w):
        ys = np.clip(np.arange(h_) + k - 2, 0, h_ - 1)
        out2 += wk * out[ys]
    return out2


def downsample2x_ref(img_f: np.ndarray) -> np.ndarray:
    """2x2 average downsample to floor(size/2) (downsample.wgsl:28-37)."""
    h, w = img_f.shape[:2]
    oh, ow = h // 2, w // 2
    v = img_f[: oh * 2, : ow * 2]
    return 0.25 * (v[0::2, 0::2] + v[1::2, 0::2] + v[0::2, 1::2] + v[1::2, 1::2])


def luminance_ref(rgba_f: np.ndarray) -> np.ndarray:
    """mean(RGB) luminance, horn_schunck.wgsl:18-21 (0.33333 each)."""
    return (rgba_f[..., 0] + rgba_f[..., 1] + rgba_f[..., 2]) * np.float32(0.33333)


def horn_schunck_step_ref(
    lum1: np.ndarray, lum2: np.ndarray, flow: np.ndarray, lam: float
) -> np.ndarray:
    """One Jacobi Horn-Schunck iteration; horn_schunck.wgsl:52-91.

    * 3x3 neighbor average of flow (center included), clamp-to-edge
    * central-difference gradients of lum1 (clamped indices)
    * It = lum2 - lum1
    * common = (Ix*ua + Iy*va + It) / (lambda + Ix^2 + Iy^2)
    * new = avg - common * (Ix, Iy)
    """
    h, w = lum1.shape
    ys, xs = np.arange(h), np.arange(w)

    # 3x3 clamped box average of flow
    avg = np.zeros_like(flow)
    for dy in (-1, 0, 1):
        yy = np.clip(ys + dy, 0, h - 1)
        for dx in (-1, 0, 1):
            xx = np.clip(xs + dx, 0, w - 1)
            avg += flow[yy][:, xx]
    avg /= 9.0

    xp1 = np.minimum(xs + 1, w - 1)
    xm1 = np.maximum(xs, 1) - 1
    yp1 = np.minimum(ys + 1, h - 1)
    ym1 = np.maximum(ys, 1) - 1
    ix = (lum1[:, xp1] - lum1[:, xm1]) * 0.5
    iy = (lum1[yp1] - lum1[ym1]) * 0.5
    it = lum2 - lum1

    common = (ix * avg[..., 0] + iy * avg[..., 1] + it) / (lam + ix * ix + iy * iy)
    out = np.empty_like(flow)
    out[..., 0] = avg[..., 0] - common * ix
    out[..., 1] = avg[..., 1] - common * iy
    return out


def flow_upsample_ref(flow: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear flow upsample via normalized-UV sampling
    (flow_upsample.wgsl:25-35): sample src at ((dst+0.5)/dst_size)*src_size."""
    in_h, in_w = flow.shape[:2]
    gx, gy = np.meshgrid(
        (np.arange(out_w, dtype=np.float32) + 0.5) * (in_w / out_w),
        (np.arange(out_h, dtype=np.float32) + 0.5) * (in_h / out_h),
    )
    return _sample_bilinear_clamp(flow, gx, gy)


def flow_refine_step_ref(
    lum1: np.ndarray, lum2: np.ndarray, flow: np.ndarray, alpha: float
) -> np.ndarray:
    """Residual HS refinement; the behavior flow_refine.wgsl:101-137 intended
    (the WGSL never compiled in the reference — SURVEY §2 C4).

    It = lum2[round-trunc(x + u_old) clamped] - lum1[x]
    update = grad * (grad.u_old + It) / (alpha^2 + |grad|^2)
    laplacian = 4-neighbor avg - center
    f_new = f_old - update + alpha * laplacian
    """
    h, w = lum1.shape
    ys, xs = np.arange(h), np.arange(w)
    xp1 = np.minimum(xs + 1, w - 1)
    xm1 = np.maximum(xs, 1) - 1
    yp1 = np.minimum(ys + 1, h - 1)
    ym1 = np.maximum(ys, 1) - 1
    ix = (lum1[:, xp1] - lum1[:, xm1]) * 0.5
    iy = (lum1[yp1] - lum1[ym1]) * 0.5

    gx, gy = np.meshgrid(xs.astype(np.float32), ys.astype(np.float32))
    # WGSL does vec2<u32>(clamp(f, 0, size-1)) — trunc to integer coords
    wx = np.clip(gx + flow[..., 0], 0, w - 1).astype(np.int64)
    wy = np.clip(gy + flow[..., 1], 0, h - 1).astype(np.int64)
    it = lum2[wy, wx] - lum1

    num = ix * flow[..., 0] + iy * flow[..., 1] + it
    den = alpha * alpha + ix * ix + iy * iy
    contrib_x = np.where(np.abs(den) > 1e-6, num / den * ix, 0.0)
    contrib_y = np.where(np.abs(den) > 1e-6, num / den * iy, 0.0)

    lap = np.zeros_like(flow)
    lap += flow[:, xp1]
    lap += flow[:, xm1]
    lap += flow[yp1]
    lap += flow[ym1]
    lap = lap * 0.25 - flow

    out = np.empty_like(flow)
    out[..., 0] = flow[..., 0] - contrib_x + alpha * lap[..., 0]
    out[..., 1] = flow[..., 1] - contrib_y + alpha * lap[..., 1]
    return out


# ---------------------------------------------------------------------------
# Overlapped-tile soft warp (the port's copy of
# nu_scaler_tpu/kernels/soft_warp_pallas.py soft_warp_blend_ref)
# ---------------------------------------------------------------------------


def soft_warp_blend_ref(
    a_u8: np.ndarray, b_u8: np.ndarray, flow: np.ndarray, time_t: float,
    tile: tuple = (8, 128), rng: int = 48, k: int = 8,
) -> np.ndarray:
    """Caveat: per-tile mean motions are floored to integer block offsets;
    when a tile mean lands EXACTLY on an integer, numpy's and XLA's
    summation order can floor to different (equally valid) offsets whose
    clipped fractions then sample up to 1 px apart. Tests must keep tile
    means off exact integers (real flows never sit on them)."""
    h, w = a_u8.shape[:2]
    th, tw = tile
    ty, tx = h // th, w // tw
    out = np.zeros((h, w, 4), np.float64)

    def corners(field):
        p = np.pad(field, ((1, 1), (1, 1)), mode="edge")
        return p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]

    for img, sign, wgt in ((a_u8, -time_t, 1.0 - time_t), (b_u8, 1.0 - time_t, time_t)):
        pad = rng + max(th, tw) // 2 + 2
        ip = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge").astype(np.float64)
        tiles = (
            flow[: ty * th, : tx * tw].reshape(ty, th, tx, tw, 2).mean(axis=(1, 3))
            * sign
        )
        tiles = np.clip(tiles, -rng, rng)
        q = np.floor(tiles).astype(np.int64)
        side = 2 * rng + 2
        ids = ((q[..., 1] + rng) * side + (q[..., 0] + rng)).reshape(-1)
        hist = np.bincount(ids, minlength=side * side)
        # stable top-k matching lax.top_k (descending value, ascending index)
        top = np.lexsort((np.arange(side * side), -hist))[:k]
        cand_y = top // side - rng
        cand_x = top % side - rng
        d2 = (q[..., 1, None] - cand_y) ** 2 + (q[..., 0, None] - cand_x) ** 2
        assign = np.argmin(d2, axis=-1)
        idx_c = corners(assign)
        sy_c = corners(tiles[..., 1])
        sx_c = corners(tiles[..., 0])
        for cyy in range(ty + 1):
            for cxx in range(tx + 1):
                for lr in range(th):
                    gr = cyy * th - th // 2 + lr
                    if not 0 <= gr < h:
                        continue
                    fyv = (lr + 0.5) / th
                    for lc in range(tw):
                        gc = cxx * tw - tw // 2 + lc
                        if not 0 <= gc < w:
                            continue
                        fxv = (lc + 0.5) / tw
                        bw = (
                            (1 - fyv) * (1 - fxv), (1 - fyv) * fxv,
                            fyv * (1 - fxv), fyv * fxv,
                        )
                        sm_y = (
                            (1 - fyv) * ((1 - fxv) * sy_c[0][cyy, cxx] + fxv * sy_c[1][cyy, cxx])
                            + fyv * ((1 - fxv) * sy_c[2][cyy, cxx] + fxv * sy_c[3][cyy, cxx])
                        )
                        sm_x = (
                            (1 - fyv) * ((1 - fxv) * sx_c[0][cyy, cxx] + fxv * sx_c[1][cyy, cxx])
                            + fyv * ((1 - fxv) * sx_c[2][cyy, cxx] + fxv * sx_c[3][cyy, cxx])
                        )
                        for c in range(4):
                            ki = idx_c[c][cyy, cxx]
                            qy, qx = cand_y[ki], cand_x[ki]
                            fyf = np.clip(sm_y - qy, 0.0, 1.0)
                            fxf = np.clip(sm_x - qx, 0.0, 1.0)
                            ry = pad + gr + qy
                            rx = pad + gc + qx
                            v = (
                                ip[ry, rx] * (1 - fyf) * (1 - fxf)
                                + ip[ry, rx + 1] * (1 - fyf) * fxf
                                + ip[ry + 1, rx] * fyf * (1 - fxf)
                                + ip[ry + 1, rx + 1] * fyf * fxf
                            )
                            out[gr, gc] += wgt * bw[c] * v
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# FSR (EASU + RCAS), the port's copy of the goldens in
# nu_scaler_tpu/kernels/reference.py (the reference's FSR1-style WGSL pair)
# ---------------------------------------------------------------------------

# Sharpness by quality tier of the FSR path.
FSR_SHARPNESS = {
    "ultra": 0.25,
    "quality": 0.17,
    "balanced": 0.12,
    "performance": 0.08,
}


def _fsr_cubic(d: np.ndarray) -> np.ndarray:
    """FsrCubic: piecewise cubic on |d|."""
    d2 = d * d
    d3 = d2 * d
    return np.where(
        d <= 1.0,
        2.0 - 1.5 * d - 0.5 * d3 + d2,
        np.where(d <= 2.0, -0.5 * d + 2.5 * d2 - d3, 0.0),
    )


def easu_ref(img_u8: np.ndarray, out_h: int, out_w: int, sharpness: float) -> np.ndarray:
    """Edge Adaptive Spatial Upsampling golden.

    Per output pixel: map its center to input coordinates, take the edge
    direction from central differences at trunc(inCoord), weight the 4×4
    neighbourhood with the FSR cubic of the direction-projected distance,
    then mix toward the center sample by `sharpness`. Alpha is 1.0.
    """
    in_h, in_w = img_u8.shape[:2]
    rgb = unpack_u8(img_u8)[..., :3]

    def fetch(py, px):
        return rgb[np.clip(py, 0, in_h - 1), np.clip(px, 0, in_w - 1)]

    ox, oy = np.meshgrid(
        (np.arange(out_w, dtype=np.float32) + 0.5) * (in_w / out_w),
        (np.arange(out_h, dtype=np.float32) + 0.5) * (in_h / out_h),
    )
    base_x = ox.astype(np.int64) - 1
    base_y = oy.astype(np.int64) - 1
    fr_x = ox - np.floor(ox)
    fr_y = oy - np.floor(oy)

    cx = ox.astype(np.int64)
    cy = oy.astype(np.int64)
    up = fetch(cy - 1, cx)
    dn = fetch(cy + 1, cx)
    lf = fetch(cy, cx - 1)
    rt = fetch(cy, cx + 1)
    vgx = np.abs(up - dn).sum(axis=-1) / 3.0
    vgy = np.abs(lf - rt).sum(axis=-1) / 3.0
    norm = np.sqrt((vgx + 1e-4) ** 2 + (vgy + 1e-4) ** 2)
    dirx = (vgx + 1e-4) / norm
    diry = (vgy + 1e-4) / norm
    wx = np.abs(dirx) / (np.abs(dirx) + np.abs(diry))
    wy = 1.0 - wx

    sum_c = np.zeros(ox.shape + (3,), dtype=np.float32)
    sum_w = np.zeros_like(ox)
    for ty in range(4):
        for tx in range(4):
            dist = np.abs((tx - fr_x) * wx + (ty - fr_y) * wy)
            wgt = _fsr_cubic(dist).astype(np.float32)
            sum_c += fetch(base_y + ty, base_x + tx) * wgt[..., None]
            sum_w += wgt
    color = sum_c / np.maximum(sum_w, 1e-4)[..., None]
    if sharpness > 1e-3:
        center = fetch(cy, cx)
        color = color + (center - color) * np.float32(sharpness)
    out = np.empty((out_h, out_w, 4), dtype=np.float32)
    out[..., :3] = color
    out[..., 3] = 1.0
    return pack_u8_trunc(out)


def rcas_ref(img_u8: np.ndarray, sharpness: float) -> np.ndarray:
    """Robust Contrast Adaptive Sharpening golden: a luma-contrast-gated
    Laplacian sharpen with neighbours clamped at the image edge; alpha 1.0."""
    h, w = img_u8.shape[:2]
    rgb = unpack_u8(img_u8)[..., :3]

    def fetch(dy, dx):
        ys = np.clip(np.arange(h) + dy, 0, h - 1)
        xs = np.clip(np.arange(w) + dx, 0, w - 1)
        return rgb[ys][:, xs]

    center = rgb
    top = fetch(-1, 0)
    bottom = fetch(1, 0)
    left = fetch(0, -1)
    right = fetch(0, 1)
    lw = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    lums = [x @ lw for x in (center, top, bottom, left, right)]
    min_l = np.minimum.reduce(lums)
    max_l = np.maximum.reduce(lums)
    t = np.clip((max_l - min_l) / 0.2, 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)  # smoothstep(0, 0.2, contrast)
    strength = sharpness * (1.0 - smooth)
    lap = 4.0 * center - top - bottom - left - right
    out = np.empty((h, w, 4), dtype=np.float32)
    out[..., :3] = center + lap * strength[..., None]
    out[..., 3] = 1.0
    return pack_u8_trunc(out)
