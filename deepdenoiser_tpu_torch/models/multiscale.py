"""Multi-scale prediction wrapper (upstream:
TensorFlow/MultiScalePrediction.py — SURVEY.md C13).

The port of deepdenoiser_tpu/models/multiscale.py: an input pyramid (2x
average pool per scale), the backbone run with shared weights at every
scale, and the coarse-to-fine composition

    out_s = pred_s + up(out_{s+1} - down(pred_s))

in which the coarse prediction replaces the low-frequency band of the finer
one. All tensors are NHWC, as the backbones take and return them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from deepdenoiser_tpu_torch.models import layers
from deepdenoiser_tpu_torch.models.layers import RFState

Tensor = torch.Tensor


def compose_scales(fine_pred: Tensor, coarse_out: Tensor) -> Tensor:
    """fine + up(coarse - down(fine)): swap in the coarse low band."""
    down_fine = layers.avg_downsample(fine_pred, 2)
    return fine_pred + layers.nearest_upsample(coarse_out - down_fine, 2)


class MultiScale:
    """Runs `backbone` over an n_scales pyramid with shared weights.

    return_scales=True returns the composed output at every scale, finest →
    coarsest (the per-scale supervision targets).

    Not an nn.Module: it owns no parameter, and in the Flax tree the shared
    backbone sits directly under the model (params/UNet_0, not under a
    wrapper's scope). The model that builds it registers the backbone, so
    the state_dict keeps those paths."""

    def __init__(self, backbone: Callable[[Tensor], Tensor], n_scales: int = 3):
        assert n_scales >= 1
        self.backbone, self.n_scales = backbone, n_scales

    def __call__(self, x: Tensor, return_scales: bool = False) -> Union[Tensor, List[Tensor]]:
        pyramid: List[Tensor] = [x]
        for _ in range(self.n_scales - 1):
            pyramid.append(layers.avg_downsample(pyramid[-1], 2))
        preds = [self.backbone(lvl) for lvl in pyramid]
        out = preds[-1]
        composed = [out]  # coarsest first
        for s in range(self.n_scales - 2, -1, -1):
            out = compose_scales(preds[s], out)
            composed.append(out)
        if return_scales:
            return composed[::-1]  # finest -> coarsest
        return out


def multiscale_rf_state(backbone_rf_fn: Callable[[RFState], RFState], n_scales: int,
                        s: Optional[RFState] = None) -> RFState:
    """Per-side RF bounds of the multi-scale composition.

    `backbone_rf_fn(state) -> state` applies the backbone's ops. Scale i's
    path: i pyramid average pools → backbone → i nearest upsamples back;
    the compose step also passes every non-coarsest prediction through one
    more pool + upsample (the `down(fine)` term). Paths merge by per-side
    max."""
    if s is None:
        s = RFState()
    total = None
    for i in range(n_scales):
        p = s
        for _ in range(i):
            p = p.pool(2)
        p = backbone_rf_fn(p)
        for _ in range(i):
            p = p.upsample(2)
        if i < n_scales - 1:  # compose_scales' down→up of the fine prediction
            p = p.pool(2).upsample(2)
        total = p if total is None else total.max_with(p)
    return total


def multiscale_receptive_field(backbone_rf: int, n_scales: int) -> int:
    """Scalar convenience bound (use multiscale_rf_state for halo sizing)."""
    f = 2 ** (n_scales - 1)
    return (backbone_rf - 1) * f + 2 * f


def multiscale_spatial_multiple(backbone_multiple: int, n_scales: int) -> int:
    return backbone_multiple * 2 ** (n_scales - 1)
