"""The port's own copy of ``raytpu/utils/ssim.py`` (the port imports nothing of
``raytpu``).

SSIM fidelity harness.

BASELINE's fidelity target is "pixel output matches the Vulkan reference
semantics within SSIM tolerance". This is a dependency-free SSIM (Wang et
al. 2004: 8×8 uniform windows, K1=0.01, K2=0.03) over grayscale or per-
channel RGB, used by the golden tests and the benchmark harness to compare
renders across backends/implementations.
"""

from __future__ import annotations

import numpy as np


def _window_means(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over non-overlapping (win, win) tiles via reshape (fast, no deps)."""
    h, w = x.shape[:2]
    hh, ww = h - h % win, w - w % win
    x = x[:hh, :ww]
    x = x.reshape(hh // win, win, ww // win, win, *x.shape[2:])
    return x.mean(axis=(1, 3))


def ssim(a: np.ndarray, b: np.ndarray, win: int = 8, data_range: float = 1.0) -> float:
    """Mean SSIM between two images (H, W) or (H, W, C) in [0, data_range]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], win, data_range)
                     for c in range(a.shape[-1])])
        )

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = _window_means(a, win)
    mu_b = _window_means(b, win)
    mu_aa = _window_means(a * a, win)
    mu_bb = _window_means(b * b, win)
    mu_ab = _window_means(a * b, win)

    var_a = mu_aa - mu_a**2
    var_b = mu_bb - mu_b**2
    cov = mu_ab - mu_a * mu_b

    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)
