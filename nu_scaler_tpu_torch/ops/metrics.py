"""Fidelity metrics of the port: the copy of `nu_scaler_tpu/ops/metrics.py`
(numpy). MSE / PSNR over the RGB channels (alpha excluded), as the
reference's `ErrorMetrics` (`Nu_scale/src/upscale/common.rs:482-531`), and a
mean SSIM on luma over non-overlapping windows.

These gate the port's paths against their numpy goldens (PSNR ≥ 50 dB).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ErrorMetrics:
    mse: float
    psnr: float
    ssim: float

    @staticmethod
    def calculate(upscaled: np.ndarray, reference: np.ndarray) -> "ErrorMetrics":
        """Both inputs are RGBA uint8 [H, W, 4] of identical shape."""
        if upscaled.shape != reference.shape:
            raise ValueError("Images must have the same dimensions")
        up = upscaled[..., :3].astype(np.float64)
        ref = reference[..., :3].astype(np.float64)
        mse = float(np.mean((up - ref) ** 2))
        psnr = float("inf") if mse <= 0.0 else 20.0 * np.log10(255.0 / np.sqrt(mse))
        return ErrorMetrics(mse=mse, psnr=psnr, ssim=ssim(upscaled, reference))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return ErrorMetrics.calculate(a, b).psnr


def ssim(a: np.ndarray, b: np.ndarray, window: int = 8) -> float:
    """Mean SSIM on the luma channel over non-overlapping windows."""
    lw = np.array([0.299, 0.587, 0.114])
    ya = a[..., :3].astype(np.float64) @ lw
    yb = b[..., :3].astype(np.float64) @ lw
    h, w = ya.shape
    h8, w8 = (h // window) * window, (w // window) * window
    if h8 == 0 or w8 == 0:
        return 1.0 if np.array_equal(a, b) else 0.0
    ya = ya[:h8, :w8].reshape(h8 // window, window, w8 // window, window)
    yb = yb[:h8, :w8].reshape(h8 // window, window, w8 // window, window)
    mu_a = ya.mean(axis=(1, 3))
    mu_b = yb.mean(axis=(1, 3))
    var_a = ya.var(axis=(1, 3))
    var_b = yb.var(axis=(1, 3))
    cov = (ya * yb).mean(axis=(1, 3)) - mu_a * mu_b
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())
