"""Per-pass normalization and its inverse, albedo demodulation, the group,
joint and rgb network encodings and the recomposition algebra, on torch
tensors.

The port of deepdenoiser_tpu/transforms.py (upstream:
TensorFlow/FeatureEngineering.py — SURVEY.md C4). Pass dicts hold
(H, W, C) tensors and the encodings are NHWC, as in the JAX package, so
the tests compare like with like. Pure elementwise PyTorch: no TPU kernel
computes the joint or rgb encode, and encode_group_inputs is the plain
version of the fused group encode (ops/fused_ingest.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS, PassKind

Tensor = torch.Tensor

# Epsilon used for albedo demodulation: demod/remod by (albedo + EPS) is an
# exact round-trip for every albedo value, including 0.
DEMOD_EPS = 1e-2


def _norm_radiance(x: Tensor) -> Tensor:
    return torch.log1p(torch.clamp_min(x, 0.0))


def _denorm_radiance(y: Tensor) -> Tensor:
    return torch.expm1(torch.clamp_min(y, 0.0))


def _identity(x: Tensor) -> Tensor:
    return x


def _norm_normal(x: Tensor) -> Tensor:
    # Screen-space normals arrive in [-1, 1]; clamp against EXR garbage.
    return torch.clamp(x, -1.0, 1.0)


def _norm_alpha(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 1.0)


_NORM = {
    PassKind.RADIANCE: _norm_radiance,
    PassKind.COLOR: _identity,
    PassKind.NORMAL: _norm_normal,
    PassKind.DEPTH: lambda x: torch.log1p(torch.clamp_min(x, 0.0)),
    PassKind.ALPHA: _norm_alpha,
}

_DENORM = {
    PassKind.RADIANCE: _denorm_radiance,
    PassKind.COLOR: _identity,
    PassKind.NORMAL: _identity,  # already in representation space
    PassKind.DEPTH: lambda y: torch.expm1(torch.clamp_min(y, 0.0)),
    PassKind.ALPHA: _identity,
}


def normalize(pass_name: str, x: Tensor, scale: float = 1.0) -> Tensor:
    """Raw pass values -> the network's input representation; `scale` is
    the statistics-driven pre-scale (e.g. 1/mean depth)."""
    f = _NORM[passes.get(pass_name).kind]
    return f(x * scale) if scale != 1.0 else f(x)


def denormalize(pass_name: str, y: Tensor, scale: float = 1.0) -> Tensor:
    """Inverse of `normalize` (up to clamping of invalid raw values)."""
    out = _DENORM[passes.get(pass_name).kind](y)
    return out / scale if scale != 1.0 else out


def _aux_scale(scales: Optional[Mapping[str, float]], name: str) -> float:
    return float(scales.get(name, 1.0)) if scales else 1.0


# Pseudo-pass key in `scales` holding the exposure pre-scale shared by every
# HDR radiance encode: log1p(exposure * radiance), inverted on decode.
RADIANCE_SCALE_KEY = "radiance"


def radiance_exposure(scales: Optional[Mapping[str, float]]) -> float:
    """The exposure pre-scale (1.0 when unset)."""
    return _aux_scale(scales, RADIANCE_SCALE_KEY)


def demodulate(radiance: Tensor, albedo: Tensor, eps: float = DEMOD_EPS) -> Tensor:
    """radiance / (albedo + eps): removes texture, leaving illumination."""
    return radiance / (albedo + eps)


def remodulate(demod: Tensor, albedo: Tensor, eps: float = DEMOD_EPS) -> Tensor:
    """Exact inverse of `demodulate` for all albedo values."""
    return demod * (albedo + eps)


def recompose(
    pass_dict: Mapping[str, Tensor],
    groups: Sequence[str] = LIGHT_GROUPS,
) -> Tensor:
    """combined = Σ_g color_g ⊙ (direct_g + indirect_g) + emission + environment.

    Missing groups/extras are skipped, so partial pass sets compose. Alpha
    is not applied here; it is carried alongside for compositing.
    """
    combined: Optional[Tensor] = None
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        if d_name in pass_dict and c_name in pass_dict:
            radiance = pass_dict[d_name]
            if i_name in pass_dict:
                radiance = radiance + pass_dict[i_name]
            term = pass_dict[c_name] * radiance
            combined = term if combined is None else combined + term
    for extra in passes.COMPOSITE_EXTRA:
        if extra in pass_dict:
            combined = pass_dict[extra] if combined is None else combined + pass_dict[extra]
    if combined is None:
        raise ValueError("recompose: no recomposable passes in input")
    return combined


def encode_group_inputs(
    pass_dict: Mapping[str, Tensor],
    group: str,
    aux: Sequence[str] = passes.AUX_PASSES,
    eps: float = DEMOD_EPS,
    scales: Optional[Mapping[str, float]] = None,
) -> Tensor:
    """The network input for one light group, stacked along channels:
    [log1p(demod direct), log1p(demod indirect), albedo, normalized aux...].
    `scales`: optional statistics-driven pre-scales, e.g. {'depth':
    1/mean_depth}, and the exposure under RADIANCE_SCALE_KEY."""
    d_name, i_name, c_name = passes.group_passes(group)
    albedo = pass_dict[c_name]
    ex = radiance_exposure(scales)
    feats = [
        _norm_radiance(ex * demodulate(pass_dict[d_name], albedo, eps)),
        _norm_radiance(ex * demodulate(pass_dict[i_name], albedo, eps)),
        albedo,
    ]
    for a in aux:
        feats.append(normalize(a, pass_dict[a], _aux_scale(scales, a)))
    return torch.cat(feats, dim=-1)


def group_input_channels(aux: Sequence[str] = passes.AUX_PASSES) -> int:
    """Channel count of encode_group_inputs' output."""
    return 9 + sum(passes.channels(a) for a in aux)


GROUP_OUTPUT_CHANNELS = 6  # denoised log-demod direct + indirect


def encode_flag_channels(flags: passes.FeatureFlags, height: int, width: int,
                         device=None) -> Tensor:
    """Feature-flag bits as constant input channels (upstream:
    FeatureFlags' flag tensors — SURVEY.md C3): lets one network train
    across scenes with heterogeneous pass sets. A float32 (height, width,
    len(flags.mask_bits())) tensor on `device`; concatenate it to any
    encoded input stack."""
    bits = torch.tensor(flags.mask_bits(), dtype=torch.float32, device=device)
    return bits.expand(height, width, bits.shape[0])


def decode_group_outputs(
    net_out: Tensor,
    albedo: Tensor,
    eps: float = DEMOD_EPS,
    scales: Optional[Mapping[str, float]] = None,
) -> Dict[str, Tensor]:
    """net_out is [log demod direct (3), log demod indirect (3)] -> raw
    {'direct', 'indirect'} for one group; `scales` must match the encode."""
    ex = radiance_exposure(scales)
    log_d, log_i = net_out[..., 0:3], net_out[..., 3:6]
    return {
        "direct": remodulate(_denorm_radiance(log_d) / ex, albedo, eps),
        "indirect": remodulate(_denorm_radiance(log_i) / ex, albedo, eps),
    }


def encode_joint_inputs(
    pass_dict: Mapping[str, Tensor],
    groups: Sequence[str] = LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
    eps: float = DEMOD_EPS,
    scales: Optional[Mapping[str, float]] = None,
) -> Tensor:
    """Every group's (log-demod direct, log-demod indirect, albedo) stacked
    into one channel stack, then the shared aux passes:
    9 * len(groups) + aux channels, NHWC-last."""
    ex = radiance_exposure(scales)
    feats = []
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        albedo = pass_dict[c_name]
        feats.append(_norm_radiance(ex * demodulate(pass_dict[d_name], albedo, eps)))
        feats.append(_norm_radiance(ex * demodulate(pass_dict[i_name], albedo, eps)))
        feats.append(albedo)
    for a in aux:
        feats.append(normalize(a, pass_dict[a], _aux_scale(scales, a)))
    return torch.cat(feats, dim=-1)


def decode_joint_outputs(
    net_out: Tensor,
    pass_dict: Mapping[str, Tensor],
    groups: Sequence[str] = LIGHT_GROUPS,
    eps: float = DEMOD_EPS,
    scales: Optional[Mapping[str, float]] = None,
) -> Dict[str, Tensor]:
    """Invert encode_joint_inputs: net_out (..., 6*G) -> raw direct and
    indirect per group (albedo taken from pass_dict)."""
    out: Dict[str, Tensor] = {}
    for i, g in enumerate(groups):
        d_name, i_name, c_name = passes.group_passes(g)
        dec = decode_group_outputs(
            net_out[..., 6 * i : 6 * (i + 1)], pass_dict[c_name], eps, scales
        )
        out[d_name] = dec["direct"]
        out[i_name] = dec["indirect"]
    return out


def joint_input_channels(
    groups: Sequence[str] = LIGHT_GROUPS, aux: Sequence[str] = passes.AUX_PASSES
) -> int:
    return 9 * len(groups) + sum(passes.channels(a) for a in aux)


def joint_output_channels(groups: Sequence[str] = LIGHT_GROUPS) -> int:
    return 6 * len(groups)


def encode_rgb_inputs(
    pass_dict: Mapping[str, Tensor],
    aux: Sequence[str] = ("normal", "depth"),
    albedo_key: str = "diffuse_color",
    scales: Optional[Mapping[str, float]] = None,
) -> Tensor:
    """Combined-RGB mode input: log noisy RGB + albedo + normalized aux."""
    feats = [_norm_radiance(radiance_exposure(scales) * pass_dict["combined"]),
             pass_dict[albedo_key]]
    for a in aux:
        feats.append(normalize(a, pass_dict[a], _aux_scale(scales, a)))
    return torch.cat(feats, dim=-1)


def decode_rgb_outputs(net_out: Tensor, scales: Optional[Mapping[str, float]] = None) -> Tensor:
    """Inverse of the combined-RGB encoding: log radiance -> radiance."""
    return _denorm_radiance(net_out) / radiance_exposure(scales)


def rgb_input_channels(aux: Sequence[str] = ("normal", "depth")) -> int:
    return 6 + sum(passes.channels(a) for a in aux)
