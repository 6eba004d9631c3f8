"""Image quality metrics on torch tensors: PSNR, SSIM, MS-SSIM
(SURVEY.md N6).

The port of deepdenoiser_tpu/ops/metrics.py. Standard definitions (Wang et
al. 2004 SSIM with an 11x11 Gaussian window, sigma 1.5, k1=.01, k2=.03;
MS-SSIM with the canonical 5-scale weights), NHWC batches, everything in
fp32. The Gaussian filter is a shift-accumulate of fp32 multiplies and
adds, a formulation that no TF32 or bf16 tensor-core path can take, where
the JAX package asks its convolution for Precision.HIGHEST.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def mse(a: Tensor, b: Tensor, axes: Optional[Tuple[int, ...]] = None) -> Tensor:
    d = (a.float() - b.float()) ** 2
    return d.mean() if axes is None else d.mean(dim=axes)


def psnr(pred: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """Peak signal-to-noise ratio in dB over the whole tensor."""
    m = mse(pred, target)
    return 10.0 * torch.log10((data_range**2) / torch.clamp_min(m, 1e-12))


def psnr_per_image(pred: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """PSNR per batch element for NHWC inputs."""
    m = mse(pred, target, axes=(1, 2, 3))
    return 10.0 * torch.log10((data_range**2) / torch.clamp_min(m, 1e-12))


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(x: Tensor, kernel: np.ndarray) -> Tensor:
    """Depthwise VALID Gaussian filter, NHWC, separable: the window is an
    outer product g⊗g, so a pass of k taps down the rows and one along the
    columns compute it with k+k taps instead of k². Each pass accumulates
    shifted slices in fp32."""
    g = np.asarray(kernel[:, 0], dtype=np.float32).reshape(-1)
    g = (g / g.sum()).tolist()  # exact 1-D factor of the outer-product window
    k = len(g)
    x = x.float()
    h, w = x.shape[1] - k + 1, x.shape[2] - k + 1
    if h < 1 or w < 1:
        raise ValueError(f"input {tuple(x.shape)} is smaller than the {k}x{k} window")
    y = g[0] * x[:, 0:h]
    for t in range(1, k):
        y = torch.add(y, x[:, t : t + h], alpha=g[t])
    z = g[0] * y[:, :, 0:w]
    for t in range(1, k):
        z = torch.add(z, y[:, :, t : t + w], alpha=g[t])
    return z


def _ssim_maps(x: Tensor, y: Tensor, data_range: float, window_size: int, sigma: float,
               k1: float, k2: float) -> Tuple[Tensor, Tensor]:
    """(ssim map, contrast-structure map) of two fp32 NHWC batches."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    w = _gaussian_kernel(window_size, sigma)
    mu_x, mu_y = _filter2d(x, w), _filter2d(y, w)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = _filter2d(x * x, w) - mu_x2
    sigma_y2 = _filter2d(y * y, w) - mu_y2
    sigma_xy = _filter2d(x * y, w) - mu_xy
    lum = (2 * mu_xy + c1) / (mu_x2 + mu_y2 + c1)
    cs = (2 * sigma_xy + c2) / (sigma_x2 + sigma_y2 + c2)
    return lum * cs, cs


def ssim(
    pred: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
) -> Tensor:
    """SSIM for NHWC batches (mean over pixels and channels per image)."""
    assert pred.dim() == 4 and target.dim() == 4, "NHWC expected"
    ssim_map, _ = _ssim_maps(pred.float(), target.float(), data_range, window_size, sigma, k1, k2)
    if return_map:
        return ssim_map
    return ssim_map.mean(dim=(1, 2, 3))


def _ssim_and_cs(x: Tensor, y: Tensor, data_range: float, window_size: int, sigma: float):
    ssim_map, cs = _ssim_maps(x, y, data_range, window_size, sigma, 0.01, 0.03)
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _pool2(x: Tensor) -> Tensor:
    """2x2 VALID mean pool, NHWC: an odd last row or column is dropped."""
    n, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def ms_ssim(
    pred: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    n_scales: int = 5,
) -> Tensor:
    """Multi-scale SSIM per image. Inputs must be >= window * 2^(n_scales-1)."""
    x, y = pred.float(), target.float()
    weights = torch.tensor(MSSSIM_WEIGHTS[:n_scales], dtype=torch.float32, device=x.device)
    weights = weights / weights.sum()
    vals = []
    for s in range(n_scales):
        s_val, cs_val = _ssim_and_cs(x, y, data_range, window_size, sigma)
        vals.append(s_val if s == n_scales - 1 else cs_val)
        if s < n_scales - 1:
            x, y = _pool2(x), _pool2(y)
    stacked = torch.stack(vals, dim=0)  # (scales, N)
    return torch.prod(torch.clamp_min(stacked, 1e-6) ** weights[:, None], dim=0)


def tonemap_for_metrics(x: Tensor) -> Tensor:
    """HDR -> [0,1] for PSNR on radiance: Reinhard x/(1+x)."""
    x = torch.clamp_min(x.float(), 0.0)
    return x / (1.0 + x)
