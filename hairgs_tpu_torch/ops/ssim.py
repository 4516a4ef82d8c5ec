"""Windowed SSIM (counterpart of hairgs_tpu/ops/ssim.py; reference
loss/losses.py:24-84): 11x11 Gaussian window, sigma 1.5, zero padding,
per-channel, C1=0.01^2, C2=0.03^2.

The separable Gaussian blur is two banded matrix products, as in the JAX
package; they run in IEEE fp32 (the package turns TF32 off at import).
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _window(window_size: int, sigma: float):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix_np(n: int, window_size: int, sigma: float):
    """(n, n) banded matrix applying the 1D Gaussian with zero SAME padding
    (edge rows truncate the kernel, as a zero-padded convolution does)."""
    g = _window(window_size, sigma)
    pad = window_size // 2
    a = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for o, wgt in enumerate(g):
        j = i + (o - pad)
        ok = (j >= 0) & (j < n)
        a[i[ok], j[ok]] = wgt
    return a


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float, device: torch.device):
    return torch.as_tensor(_band_matrix_np(n, window_size, sigma), device=device)


def _filter(img, window_size: int = 11, sigma: float = 1.5):
    """Separable Gaussian blur of img (H,W,C) as two banded products."""
    h, w, _ = img.shape
    ah = _band_matrix(h, window_size, sigma, img.device)
    aw = _band_matrix(w, window_size, sigma, img.device)
    x = torch.einsum("ih,hwc->iwc", ah, img)
    return torch.einsum("jw,hwc->hjc", aw, x)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over the image; img1/img2 are (H,W,C) in [0,1]."""
    f = functools.partial(_filter, window_size=window_size, sigma=sigma)
    mu1 = f(img1)
    mu2 = f(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = f(img1 * img1) - mu1_sq
    sigma2_sq = f(img2 * img2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
