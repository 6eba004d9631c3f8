"""Typed dataclass configs with JSON round-trip, and the presets the port
runs.

The port of deepdenoiser_tpu/config.py. `ModelConfig` (models/factory.py),
`DataConfig`, `TrainConfig` (with `LossConfig`, ops/losses.py) and
`InferenceConfig` keep every JAX field name and default, so the same
values describe the same experiment in both packages and a JSON saved by
either loads in the other. `PRESETS` holds every preset of the JAX
package under its name: `flagship-max` and `kpn` (group-mode 2-slot KPN),
`kpn-hq` (joint 8-slot KPN), `flagship-hq` and `flagship-mc` (joint
residual, stride-1 stem), `flagship` and `flagship-flags` (joint residual,
space-to-depth stem; the latter flag-conditioned), `tiramisu`,
`tiramisu-fast` and `tiramisu-lt1` (joint residual FC-DenseNets),
`unet-multiscale` (no release weights) and `unet-small`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple, Type, TypeVar, get_args, get_origin, get_type_hints

from deepdenoiser_tpu_torch import transforms
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops.losses import LossConfig
from deepdenoiser_tpu_torch.passes import AUX_PASSES, LIGHT_GROUPS

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """prepare-data, loader and encode settings (same names and defaults
    as the JAX package's DataConfig). `shuffle_buffer` is carried so
    configs round-trip; the loader shuffles the whole index space per
    epoch (data/loader.py). `read_threads` is the loader's thread count
    (0 = min(4, usable CPUs)) and `prefetch_batches` the batches it builds
    ahead (0 = 8)."""

    shard_dir: str = "data/shards"
    crop: int = 64
    crops_per_frame: int = 64
    batch_size: int = 32
    groups: Tuple[str, ...] = LIGHT_GROUPS
    mode: str = "group"  # 'group' (per-group) | 'joint' (all groups, one pass) | 'rgb'
    group: str = "diffuse"  # which group a 'group'-mode model trains on
    use_flags: bool = False
    stats_normalize: bool = False
    pass_scales: Tuple[Tuple[str, float], ...] = ()
    augment: bool = True
    shuffle_buffer: int = 2048
    validation_fraction: float = 0.1
    seed: int = 0
    read_threads: int = 0
    prefetch_batches: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and checkpointing (same names and defaults as
    the JAX package's TrainConfig). `data_parallel` belongs to the
    multi-device slice: one card trains unsharded."""

    steps: int = 10_000
    learning_rate: float = 2e-4
    warmup_steps: int = 500
    schedule: str = "cosine"  # 'cosine' | 'constant'
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip_norm: float = 1.0
    ema_decay: float = 0.0  # >0 keeps a parameter EMA for eval
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    log_every: int = 100
    eval_every: int = 1000
    data_parallel: bool = True
    # >0 with a multi-scale model: supervise the composed output at every
    # pyramid scale against the average-downsampled target
    scale_supervision_weight: float = 0.0
    # >0: loss = (1-w)*loss(ground truth) + w*loss(batch['y_teacher'])
    distill_weight: float = 0.0
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Full-frame inference settings (same fields as the JAX package's).
    spatial_shard belongs to the multi-device modes and raises in
    inference/pipeline.py."""

    tile: int = 0  # core tile size; 0 = whole-frame
    tile_batch: int = 0  # tiles per network call; 0 = all tiles in one batch
    halo: int = 0  # 0 = derive from the model's certified RF bound
    # 'exact' center-crop reassembly (equal to the whole frame when halo >=
    # the certified bound) or 'feather' cosine overlap blending
    stitch: str = "exact"
    # Whole-frame border pad override (ignored when tiling, where the
    # certified halo is a correctness requirement); -1 = the certified halo.
    border: int = -1
    compute_dtype: str = "bfloat16"
    spatial_shard: bool = False
    # Group mode: encode with the fused ingest kernels (ops/fused_ingest.py)
    # instead of transforms.encode_group_inputs. The field keeps the JAX
    # package's name so configs load in both packages.
    use_pallas_ingest: bool = False
    # Kept so configs load in both packages. On the card the KPN filter
    # apply is always the CUDA kernel; on the CPU its plain version.
    kpn_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)


# ---------------------------------------------------------------------------
# Generic dataclass <-> JSON
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _from_dict(cls: Type[T], d: Any) -> T:
    if not dataclasses.is_dataclass(cls):
        origin = get_origin(cls)
        if origin is tuple or cls is tuple:
            args = get_args(cls)
            if args and args[-1] is Ellipsis:
                return tuple(_from_dict(args[0], v) for v in d)  # type: ignore
            return tuple(d)  # type: ignore
        return d  # primitives pass through
    hints = get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in d.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__}: unknown config key {key!r}")
        kwargs[key] = _from_dict(hints[key], val)
    return cls(**kwargs)  # type: ignore


def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    return _from_dict(cls, d)


def save(cfg: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2) + "\n")


def load(path: str | Path, cls: Type[T] = ExperimentConfig) -> T:
    return from_dict(cls, json.loads(Path(path).read_text()))


def _unet64(**kw) -> ModelConfig:
    return ModelConfig(
        backbone="unet", base_width=64, depth=3, convs_per_level=2,
        stem_stride=1, compute_dtype="bfloat16", act="leaky_relu", **kw,
    )


def _tiramisu(**kw) -> ModelConfig:
    return ModelConfig(
        backbone="tiramisu", growth_rate=16, layers_per_block=4, depth=3,
        compute_dtype="bfloat16", predict_residual=True, act="leaky_relu", **kw,
    )


PRESETS: Dict[str, ExperimentConfig] = {
    # joint 4-group single pass, space-to-depth stem, base width 96
    "flagship": ExperimentConfig(
        name="flagship",
        model=ModelConfig(
            backbone="unet", base_width=96, depth=3, convs_per_level=2,
            stem_stride=2, compute_dtype="bfloat16", predict_residual=True,
            act="leaky_relu",
        ),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # flagship's model trained across frames that lack some light groups:
    # one presence plane per group after the 41 channels
    "flagship-flags": ExperimentConfig(
        name="flagship-flags",
        model=ModelConfig(
            backbone="unet", base_width=96, depth=3, convs_per_level=2,
            stem_stride=2, compute_dtype="bfloat16", predict_residual=True,
            act="leaky_relu",
        ),
        data=DataConfig(mode="joint", use_flags=True),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # stride-1 UNet, base width 64, depth 3, residual prediction
    "flagship-hq": ExperimentConfig(
        name="flagship-hq",
        model=_unet64(predict_residual=True),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # the same architecture, weights fine-tuned on Monte-Carlo-traced noise
    "flagship-mc": ExperimentConfig(
        name="flagship-mc",
        model=_unet64(predict_residual=True),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # kernel prediction in group mode: a 2-slot 5x5 KPN head on a base-48
    # UNet, applied to each light group
    "flagship-max": ExperimentConfig(
        name="flagship-max",
        model=ModelConfig(
            backbone="unet", base_width=48, depth=3, convs_per_level=2,
            kernel_prediction=True, kpn_size=5, kpn_slots=2,
            kpn_logit_norm=True,
            compute_dtype="bfloat16", act="leaky_relu",
        ),
        data=DataConfig(mode="group"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    "unet-small": ExperimentConfig(
        name="unet-small",
        model=ModelConfig(backbone="unet", base_width=32, depth=3, n_scales=1),
    ),
    # multi-scale wrapper over a base-48 UNet; no release weights
    "unet-multiscale": ExperimentConfig(
        name="unet-multiscale",
        model=ModelConfig(backbone="unet", base_width=48, depth=3, n_scales=3,
                          compute_dtype="bfloat16", predict_residual=True,
                          act="leaky_relu"),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999, scale_supervision_weight=0.5),
    ),
    # FC-DenseNet with full dense concats on the up path
    "tiramisu": ExperimentConfig(
        name="tiramisu",
        model=_tiramisu(),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # the same with 1x1-bottlenecked up-path joins
    "tiramisu-fast": ExperimentConfig(
        name="tiramisu-fast",
        model=_tiramisu(up_compress=64),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # tiramisu-fast with the two full-resolution dense blocks thinned to
    # one layer each
    "tiramisu-lt1": ExperimentConfig(
        name="tiramisu-lt1",
        model=_tiramisu(up_compress=64, layers_top=1),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
    # flagship-max's model with the certified halo as the border
    "kpn": ExperimentConfig(
        name="kpn",
        model=ModelConfig(
            backbone="unet", base_width=48, depth=3, kernel_prediction=True,
            kpn_size=5, kpn_slots=2, kpn_logit_norm=True,
            compute_dtype="bfloat16", act="leaky_relu",
        ),
        data=DataConfig(mode="group"),
        train=TrainConfig(ema_decay=0.999),
    ),
    # the flagship-hq backbone with an 8-slot 5x5 kernel-prediction head
    "kpn-hq": ExperimentConfig(
        name="kpn-hq",
        model=_unet64(kernel_prediction=True, kpn_size=5, kpn_slots=8,
                      kpn_logit_norm=True),
        data=DataConfig(mode="joint"),
        train=TrainConfig(ema_decay=0.999),
        infer=InferenceConfig(border=32),
    ),
}


def input_channels(data: DataConfig, aux: Tuple[str, ...] = AUX_PASSES) -> int:
    """Channels of the encoded network input for the data mode (rgb mode
    takes no alpha)."""
    if data.use_flags and data.mode != "joint":
        raise ValueError("use_flags requires mode='joint'")
    if data.mode == "group":
        return transforms.group_input_channels(tuple(aux))
    if data.mode == "joint":
        n = transforms.joint_input_channels(tuple(data.groups), tuple(aux))
        return n + (len(data.groups) if data.use_flags else 0)
    if data.mode == "rgb":
        return transforms.rgb_input_channels(tuple(a for a in aux if a != "alpha"))
    raise ValueError(f"unknown data mode {data.mode!r}")


def output_channels(data: DataConfig) -> int:
    if data.mode == "group":
        return transforms.GROUP_OUTPUT_CHANNELS
    if data.mode == "joint":
        return transforms.joint_output_channels(tuple(data.groups))
    if data.mode == "rgb":
        return 3
    raise ValueError(f"unknown data mode {data.mode!r}")


def validate_channels(cfg: ExperimentConfig) -> ExperimentConfig:
    """Set the model's channel counts from the data mode (group 14 in / 6
    out, joint 41 / 24 or 45 / 24 with flags, rgb 10 / 3), as the JAX
    training loop's _validate_channels does."""
    want_in, want_out = input_channels(cfg.data), output_channels(cfg.data)
    m = cfg.model
    if m.in_channels != want_in or m.out_channels != want_out:
        m = dataclasses.replace(m, in_channels=want_in, out_channels=want_out)
        cfg = dataclasses.replace(cfg, model=m)
    return cfg
