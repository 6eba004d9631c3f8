"""Model factory: one config dataclass → (torch module, receptive field,
spatial multiple).

The port of deepdenoiser_tpu/models/factory.py. `ModelConfig` keeps the
JAX field names, so a config JSON loads in both packages. Backbones: the
UNet (stride-1 or space-to-depth stem), the tiramisu, and the KPCN of Bako
et al. (models/kpcn.py, the port's own: base_width is its hidden width,
depth its number of 5x5 convs), each alone or under the multi-scale
wrapper (n_scales > 1). Heads: the KPN head in
joint mode (24 output channels, 8 slots) and in group or rgb mode (the
leading 3*kpn_slots input channels are the signal), or the residual
branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from deepdenoiser_tpu_torch import tracing
from deepdenoiser_tpu_torch.models import kpn, layers, multiscale
from deepdenoiser_tpu_torch.models.kpcn import KPCN, KPCNSpec
from deepdenoiser_tpu_torch.models.tiramisu import Tiramisu, TiramisuSpec
from deepdenoiser_tpu_torch.models.unet import UNet, UNetSpec

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture spec (same fields as the JAX package's ModelConfig)."""

    backbone: str = "unet"  # 'unet' | 'tiramisu' | 'kpcn'
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


class DenoiserModel(nn.Module):
    """Top-level module: (multi-scale) backbone, optionally KPN-headed or
    residual.

    forward(x) takes the encoded feature stack, NHWC fp32, and returns
    NHWC fp32. Child names follow the Flax tree: the backbone is UNet_0,
    Tiramisu_0 or KPCN_0 directly under the model, with or without the multi-scale
    wrapper or the head around it, and the head's temperature is
    KernelPredictionHead_0.kernel_temp; so release weights map by path.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        out_ch = cfg.kpn_slots * cfg.kpn_size**2 if cfg.kernel_prediction else cfg.out_channels
        spec = _backbone_spec(cfg)
        name, module = BACKBONES[cfg.backbone]
        setattr(self, name, module(spec, cfg.in_channels, out_ch, dtype=cfg.dtype))
        if cfg.kernel_prediction:
            if cfg.out_channels == 24 and 3 * cfg.kpn_slots != cfg.out_channels:
                raise ValueError(
                    f"joint KPN needs kpn_slots={cfg.out_channels // 3}, got {cfg.kpn_slots}"
                )
            self.KernelPredictionHead_0 = kpn.KernelPredictionHead(
                cfg.kpn_size, cfg.kpn_slots, logit_norm=cfg.kpn_logit_norm
            )

    @property
    def net(self):
        """The network under the head: the backbone, or its multi-scale
        wrapper (which owns no parameter and is not a registered child)."""
        cfg = self.cfg
        backbone = getattr(self, BACKBONES[cfg.backbone][0])
        return multiscale.MultiScale(backbone, cfg.n_scales) if cfg.n_scales > 1 else backbone

    def forward(self, x: Tensor, return_scales: bool = False) -> Union[Tensor, List[Tensor]]:
        cfg = self.cfg
        if return_scales:
            assert cfg.n_scales > 1 and not cfg.kernel_prediction, (
                "return_scales needs a multi-scale, non-KPN model"
            )
            outs = self.net(x, return_scales=True)  # finest -> coarsest
            if cfg.predict_residual:
                # anchor every scale to its downsampled noisy signal
                signal = _slice_signal(cfg, x)
                fixed = []
                for s, o in enumerate(outs):
                    fixed.append(o + signal.to(o.dtype))
                    if s < len(outs) - 1:
                        signal = layers.avg_downsample(signal, 2)
                outs = fixed
            return outs
        with tracing.span("backbone"):
            x = x.contiguous()  # the signal slices below need channel stride 1
            out = self.net(x)
        with tracing.span("head"):
            if cfg.kernel_prediction:
                # KPN filters the encoded (log-demod) signal channels. Joint
                # mode: slot order g0_d, g0_i, g1_d, ... as decode_joint_outputs
                # expects. Group and rgb mode: the leading 3*kpn_slots channels
                # (the convention of encode_group_inputs / encode_rgb_inputs).
                if cfg.out_channels == 24:
                    signal = _slice_signal(cfg, x)
                else:
                    signal = x[..., : 3 * cfg.kpn_slots]
                return self.KernelPredictionHead_0(out, signal)
            if cfg.predict_residual:
                out = out + _slice_signal(cfg, x).to(out.dtype)
            return out


# each backbone's child name under the model (its Flax scope) and module
BACKBONES = {"unet": ("UNet_0", UNet), "tiramisu": ("Tiramisu_0", Tiramisu),
             "kpcn": ("KPCN_0", KPCN)}


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


def _backbone_spec(cfg: ModelConfig) -> Union[UNetSpec, TiramisuSpec, KPCNSpec]:
    if cfg.backbone == "unet":
        return UNetSpec(
            base_width=cfg.base_width, depth=cfg.depth,
            convs_per_level=cfg.convs_per_level, act=cfg.act,
            stem_stride=cfg.stem_stride, remat=cfg.remat,
        )
    if cfg.backbone == "tiramisu":
        return TiramisuSpec(
            growth_rate=cfg.growth_rate, layers_per_block=cfg.layers_per_block,
            depth=cfg.depth, act=cfg.act, stem_stride=cfg.stem_stride,
            up_compress=cfg.up_compress, layers_top=cfg.layers_top,
        )
    if cfg.backbone == "kpcn":
        return KPCNSpec(width=cfg.base_width, n_convs=cfg.depth, act=cfg.act)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


def rf_state(cfg: ModelConfig):
    """Certified per-side RF bounds for the full model (backbone +
    multi-scale + KPN): the tiling engine's source for the halo."""
    spec = _backbone_spec(cfg)
    if cfg.n_scales > 1:
        s = multiscale.multiscale_rf_state(spec.rf_state, cfg.n_scales)
    else:
        s = spec.rf_state()
    if cfg.kernel_prediction:
        s = s.conv(cfg.kpn_size)  # per-pixel filter = one more kxk window
    return s


def receptive_field(cfg: ModelConfig) -> int:
    return rf_state(cfg).r


def halo(cfg: ModelConfig) -> int:
    """One-sided halo (pixels) guaranteeing seam-free tiled inference."""
    return rf_state(cfg).halo


def spatial_multiple(cfg: ModelConfig) -> int:
    m = _backbone_spec(cfg).spatial_multiple
    if cfg.n_scales > 1:
        m = multiscale.multiscale_spatial_multiple(m, cfg.n_scales)
    return m


def build_model(cfg: ModelConfig) -> DenoiserModel:
    return DenoiserModel(cfg)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None) -> DenoiserModel:
    """A model initialised as the JAX package's `init_params` initialises
    its Flax tree: every conv kernel lecun-normal (layers.lecun_normal_),
    every bias zero, the backbone's output conv (the UNet's and tiramisu's
    1x1 head, the KPCN's last conv) zero when the model predicts a
    residual without a KPN head (`head_zero_init`, so it starts as the
    identity), the KPN temperatures at t0. Draws come from `generator`, in
    the order the modules are registered; jax.random's bits are not
    reproduced, only their distributions."""
    model = build_model(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                layers.lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
        if cfg.predict_residual and not cfg.kernel_prediction:
            backbone = getattr(model, BACKBONES[cfg.backbone][0])
            (backbone.head if cfg.backbone == "kpcn" else backbone.Conv_0).weight.zero_()
        if cfg.kernel_prediction and cfg.kpn_logit_norm:
            head = model.KernelPredictionHead_0
            head.kernel_temp.fill_(
                math.log(head.TEMP_INIT / (head.TEMP_MAX - head.TEMP_INIT)))
    return model
