"""Loss library (upstream: TensorFlow/LossDifference.py — SURVEY.md C15).

The port of deepdenoiser_tpu/ops/losses.py: L1 / L2 / SMAPE-style relative
error / Huber, composed per pass with an optional finite-difference
gradient term and an MS-SSIM term, maskable by feature flags. Pure
functions over NHWC tensors, accumulated in fp32 whatever the model's
compute dtype.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from deepdenoiser_tpu_torch.ops import metrics

Tensor = torch.Tensor


def _abs(x: Tensor) -> Tensor:
    """|x| with JAX's derivative: +1 at x == 0 (jnp.abs differentiates as
    select(x >= 0, g, -g)), where torch.abs gives 0. The two differ on
    every exactly-zero prediction, e.g. a pixel that a ReLU net's linear
    head maps to 0 at initialisation."""
    return torch.where(x >= 0, x, -x)


class LossKind(str, enum.Enum):
    L1 = "l1"
    L2 = "l2"
    SMAPE = "smape"
    HUBER = "huber"


def difference(kind: LossKind | str, pred: Tensor, target: Tensor, eps: float = 1e-2) -> Tensor:
    """Elementwise difference map (no reduction)."""
    kind = LossKind(kind)
    p, t = pred.float(), target.float()
    if kind is LossKind.L1:
        return _abs(p - t)
    if kind is LossKind.L2:
        return (p - t) ** 2
    if kind is LossKind.SMAPE:
        return _abs(p - t) / (_abs(p) + _abs(t) + eps)
    if kind is LossKind.HUBER:
        d = _abs(p - t)
        return torch.where(d <= 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError(kind)


def _spatial_gradients(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Forward differences along H and W (NHWC), zero-padded at the far
    edge so shapes stay as they were."""
    dy = F.pad(x[:, 1:] - x[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))
    return dy, dx


def gradient_difference(kind: LossKind | str, pred: Tensor, target: Tensor) -> Tensor:
    """Difference of spatial gradients — the reference's 'variation' term."""
    pdy, pdx = _spatial_gradients(pred.float())
    tdy, tdx = _spatial_gradients(target.float())
    return difference(kind, pdy, tdy) + difference(kind, pdx, tdx)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Same fields and defaults as the JAX package's LossConfig."""

    kind: str = "smape"
    gradient_weight: float = 0.5
    gradient_kind: str = "l1"
    ms_ssim_weight: float = 0.0  # >0 mixes in (1 - MS-SSIM); needs >=176px crops at 5 scales
    ms_ssim_scales: int = 3
    eps: float = 1e-2


def pass_loss(cfg: LossConfig, pred: Tensor, target: Tensor,
              mask: Optional[Tensor] = None) -> Tensor:
    """Scalar loss for one predicted pass (NHWC). `mask` (N,1,1,C or
    N,H,W,1) zeroes examples or pixels whose pass is absent (feature
    flags); the mean is then over the unmasked elements."""
    diff = difference(cfg.kind, pred, target, cfg.eps)
    if cfg.gradient_weight > 0:
        diff = diff + cfg.gradient_weight * gradient_difference(cfg.gradient_kind, pred, target)
    if mask is not None:
        diff = diff * mask
        denom = torch.clamp_min(torch.broadcast_to(mask, diff.shape).sum(), 1.0)
        total = diff.sum() / denom
    else:
        total = diff.mean()
    if cfg.ms_ssim_weight > 0:
        tm_p = metrics.tonemap_for_metrics(pred)
        tm_t = metrics.tonemap_for_metrics(target)
        ms = metrics.ms_ssim(tm_p, tm_t, n_scales=cfg.ms_ssim_scales).mean()
        total = total + cfg.ms_ssim_weight * (1.0 - ms)
    return total


def multi_pass_loss(
    cfg: LossConfig,
    preds: Mapping[str, Tensor],
    targets: Mapping[str, Tensor],
    weights: Optional[Mapping[str, float]] = None,
    masks: Optional[Mapping[str, Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Weighted sum of per-pass losses. Returns (total, per-pass scalars)."""
    per_pass: Dict[str, Tensor] = {}
    total = None
    for name, pred in preds.items():
        w = float(weights.get(name, 1.0)) if weights else 1.0
        mask = masks.get(name) if masks else None
        lp = pass_loss(cfg, pred, targets[name], mask)
        per_pass[name] = lp
        total = w * lp if total is None else total + w * lp
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return total, per_pass
