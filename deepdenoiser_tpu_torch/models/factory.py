"""Model factory: one config dataclass → (torch module, receptive field,
spatial multiple).

The port of deepdenoiser_tpu/models/factory.py. `ModelConfig` keeps the
JAX field names, so a config JSON loads in both packages. Ported here: the
UNet backbone with a stride-1 stem, the joint-mode KPN head (24 output
channels, 8 slots) and the residual branch. The tiramisu backbone,
multi-scale models and group- or rgb-mode KPN raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.models.unet import UNet, UNetSpec

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture spec (same fields as the JAX package's ModelConfig)."""

    backbone: str = "unet"  # 'unet' | 'tiramisu'
    in_channels: int = 14
    out_channels: int = 6
    n_scales: int = 1  # >1 enables multi-scale prediction
    kernel_prediction: bool = False
    kpn_size: int = 5
    kpn_slots: int = 2  # e.g. direct + indirect
    kpn_pallas: bool = False  # kept so configs load; the card always uses the kernel
    kpn_logit_norm: bool = False
    # out = net(x) + signal_channels(x)
    predict_residual: bool = False
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # unet params
    base_width: int = 64
    depth: int = 3
    convs_per_level: int = 2
    act: str = "relu"
    stem_stride: int = 1  # 2 = space-to-depth stem
    remat: bool = False
    # tiramisu params
    growth_rate: int = 16
    layers_per_block: int = 4
    up_compress: int = 0
    layers_top: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.backbone != "unet":
        raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")
    if cfg.n_scales > 1:
        raise NotImplementedError("multi-scale models are not ported yet")
    if cfg.kernel_prediction and cfg.out_channels != 24:
        raise NotImplementedError("only joint-mode (24-channel) KPN is ported yet")


class DenoiserModel(nn.Module):
    """Top-level module: UNet backbone, optionally KPN-headed or residual.

    forward(x) takes the encoded feature stack, NHWC fp32, and returns
    NHWC fp32. Child names follow the Flax tree (UNet_0,
    KernelPredictionHead_0), so release weights map by path.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        out_ch = cfg.kpn_slots * cfg.kpn_size**2 if cfg.kernel_prediction else cfg.out_channels
        spec = _backbone_spec(cfg)
        self.UNet_0 = UNet(spec, cfg.in_channels, out_ch, dtype=cfg.dtype)
        if cfg.kernel_prediction:
            if 3 * cfg.kpn_slots != cfg.out_channels:
                raise ValueError(
                    f"joint KPN needs kpn_slots={cfg.out_channels // 3}, got {cfg.kpn_slots}"
                )
            self.KernelPredictionHead_0 = kpn.KernelPredictionHead(
                cfg.kpn_size, cfg.kpn_slots, logit_norm=cfg.kpn_logit_norm
            )

    def forward(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = x.contiguous()  # the signal slices below need channel stride 1
        out = self.UNet_0(x)
        if cfg.kernel_prediction:
            # KPN filters the encoded (log-demod) signal channels, slot
            # order g0_d, g0_i, g1_d, ... as decode_joint_outputs expects.
            return self.KernelPredictionHead_0(out, _slice_signal(cfg, x))
        if cfg.predict_residual:
            out = out + _slice_signal(cfg, x).to(out.dtype)
        return out


def _slice_signal(cfg: ModelConfig, x: Tensor) -> Tensor:
    """Noisy encoded signal channels of x matching the output channels,
    gathered from contiguous runs."""
    idx = signal_indices(cfg)
    runs = []
    start = 0
    for i in range(1, len(idx) + 1):
        if i == len(idx) or idx[i] != idx[i - 1] + 1:
            runs.append(x[..., idx[start] : idx[i - 1] + 1])
            start = i
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim=-1)


def signal_indices(cfg: ModelConfig) -> Tuple[int, ...]:
    """Input-channel indices of the noisy encoded signal matching the
    output channels (the encode conventions of transforms.py)."""
    if cfg.out_channels == 24:  # joint: [demod_d(3), demod_i(3), albedo(3)]*4 + aux
        return tuple(9 * g + j for g in range(4) for j in range(6))
    if cfg.out_channels == 6:  # group: [demod_d(3), demod_i(3), albedo, aux]
        return tuple(range(6))
    if cfg.out_channels == 3:  # rgb: [log combined(3), albedo, aux]
        return tuple(range(3))
    raise ValueError(
        f"predict_residual needs a known channel convention; out_channels="
        f"{cfg.out_channels} is not one of 3/6/24"
    )


def _backbone_spec(cfg: ModelConfig) -> UNetSpec:
    if cfg.backbone == "unet":
        return UNetSpec(
            base_width=cfg.base_width, depth=cfg.depth,
            convs_per_level=cfg.convs_per_level, act=cfg.act,
            stem_stride=cfg.stem_stride, remat=cfg.remat,
        )
    raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")


def rf_state(cfg: ModelConfig):
    """Certified per-side RF bounds for the full model (backbone + KPN)."""
    if cfg.n_scales > 1:
        raise NotImplementedError("multi-scale models are not ported yet")
    s = _backbone_spec(cfg).rf_state()
    if cfg.kernel_prediction:
        s = s.conv(cfg.kpn_size)  # per-pixel filter = one more kxk window
    return s


def receptive_field(cfg: ModelConfig) -> int:
    return rf_state(cfg).r


def halo(cfg: ModelConfig) -> int:
    """One-sided halo (pixels) guaranteeing seam-free tiled inference."""
    return rf_state(cfg).halo


def spatial_multiple(cfg: ModelConfig) -> int:
    if cfg.n_scales > 1:
        raise NotImplementedError("multi-scale models are not ported yet")
    return _backbone_spec(cfg).spatial_multiple


def build_model(cfg: ModelConfig) -> DenoiserModel:
    return DenoiserModel(cfg)
