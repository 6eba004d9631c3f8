"""Typed dataclass configs and the presets this slice of the port runs.

The port of deepdenoiser_tpu/config.py for inference: `InferenceConfig`
(and `models.factory.ModelConfig`) keep every JAX field name, and
`DataConfig` the ones inference reads, so the same values describe the
same experiment in both packages. Presets: the joint-mode stride-1 UNet family — `kpn-hq`
(8-slot 5x5 KPN head), `flagship-hq` and `flagship-mc` (residual).
Training configs are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from deepdenoiser_tpu_torch import transforms
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.passes import AUX_PASSES, LIGHT_GROUPS


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The input settings inference reads (same names and defaults as the
    JAX package's DataConfig; its loader and training fields come with the
    loader slice)."""

    groups: Tuple[str, ...] = LIGHT_GROUPS
    mode: str = "group"  # 'group' | 'joint' | 'rgb'
    use_flags: bool = False
    pass_scales: Tuple[Tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Full-frame inference settings (same fields as the JAX package's).

    This slice runs whole-frame mode only (tile=0, no tile_batch, exact
    stitching, no spatial sharding); the other settings raise in
    inference/pipeline.py.
    """

    tile: int = 0  # core tile size; 0 = whole-frame
    tile_batch: int = 0
    halo: int = 0  # 0 = derive from the model's certified RF bound
    stitch: str = "exact"
    # Whole-frame border pad override; -1 = the certified halo.
    border: int = -1
    compute_dtype: str = "bfloat16"
    spatial_shard: bool = False
    use_pallas_ingest: bool = False
    # Kept so configs load in both packages. On the card the KPN filter
    # apply is always the CUDA kernel; on the CPU its plain version.
    kpn_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    infer: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)


def _unet64(**kw) -> ModelConfig:
    return ModelConfig(
        backbone="unet", base_width=64, depth=3, convs_per_level=2,
        stem_stride=1, compute_dtype="bfloat16", act="leaky_relu", **kw,
    )


PRESETS: Dict[str, ExperimentConfig] = {
    # stride-1 UNet, base width 64, depth 3, residual prediction
    "flagship-hq": ExperimentConfig(
        name="flagship-hq",
        model=_unet64(predict_residual=True),
        data=DataConfig(mode="joint"),
        infer=InferenceConfig(border=32),
    ),
    # the same architecture, weights fine-tuned on Monte-Carlo-traced noise
    "flagship-mc": ExperimentConfig(
        name="flagship-mc",
        model=_unet64(predict_residual=True),
        data=DataConfig(mode="joint"),
        infer=InferenceConfig(border=32),
    ),
    # the flagship-hq backbone with an 8-slot 5x5 kernel-prediction head
    "kpn-hq": ExperimentConfig(
        name="kpn-hq",
        model=_unet64(kernel_prediction=True, kpn_size=5, kpn_slots=8,
                      kpn_logit_norm=True),
        data=DataConfig(mode="joint"),
        infer=InferenceConfig(border=32),
    ),
}


def input_channels(data: DataConfig) -> int:
    if data.mode != "joint":
        raise NotImplementedError(f"mode {data.mode!r} is not ported yet (joint only)")
    n = transforms.joint_input_channels(tuple(data.groups), AUX_PASSES)
    return n + (len(data.groups) if data.use_flags else 0)


def output_channels(data: DataConfig) -> int:
    if data.mode != "joint":
        raise NotImplementedError(f"mode {data.mode!r} is not ported yet (joint only)")
    return transforms.joint_output_channels(tuple(data.groups))


def validate_channels(cfg: ExperimentConfig) -> ExperimentConfig:
    """Set the model's channel counts from the data mode (joint: 41 in,
    24 out), as the JAX training loop's _validate_channels does."""
    want_in, want_out = input_channels(cfg.data), output_channels(cfg.data)
    m = cfg.model
    if m.in_channels != want_in or m.out_channels != want_out:
        m = dataclasses.replace(m, in_channels=want_in, out_channels=want_out)
        cfg = dataclasses.replace(cfg, model=m)
    return cfg
