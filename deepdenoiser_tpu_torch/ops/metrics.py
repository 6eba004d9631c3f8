"""Image quality metrics on torch tensors (SURVEY.md N6).

The port of psnr and tonemap_for_metrics from
deepdenoiser_tpu/ops/metrics.py; computed in fp32. SSIM and MS-SSIM are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def mse(a: Tensor, b: Tensor, axes: Optional[Tuple[int, ...]] = None) -> Tensor:
    d = (a.float() - b.float()) ** 2
    return d.mean() if axes is None else d.mean(dim=axes)


def psnr(pred: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """Peak signal-to-noise ratio in dB over the whole tensor."""
    m = mse(pred, target)
    return 10.0 * torch.log10((data_range**2) / torch.clamp_min(m, 1e-12))


def tonemap_for_metrics(x: Tensor) -> Tensor:
    """HDR -> [0,1] for PSNR on radiance: Reinhard x/(1+x)."""
    x = torch.clamp_min(x.float(), 0.0)
    return x / (1.0 + x)
