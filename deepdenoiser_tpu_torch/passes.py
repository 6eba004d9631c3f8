"""Render-pass registry and canonical naming for the PyTorch package.

A copy of deepdenoiser_tpu/passes.py (the registry, light groups, aux and
composite pass lists; upstream: TensorFlow/RenderPasses.py — SURVEY.md C1)
kept here because the port imports nothing of the JAX package. Every pass
the denoiser touches, its channel count, value kind and role in the
recomposition

    combined = sum_over_groups color_g * (direct_g + indirect_g)
             + emission + environment        (alpha carried for compositing)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class PassKind(enum.Enum):
    """Value semantics of a pass — drives normalization (transforms.py)."""

    RADIANCE = "radiance"  # HDR, >= 0, log-compressed (direct/indirect/emission/env/combined)
    COLOR = "color"  # albedo-like, ~[0, 1], noise-free-ish, identity norm
    NORMAL = "normal"  # screen-space normal, [-1, 1]
    DEPTH = "depth"  # >= 0, unbounded, log-compressed + scaled
    ALPHA = "alpha"  # [0, 1]


class Role(enum.Enum):
    """Role of a pass inside its light group (or 'aux' outside groups)."""

    DIRECT = "direct"
    INDIRECT = "indirect"
    COLOR = "color"
    AUX = "aux"
    COMPOSITE = "composite"  # combined / emission / environment


# The four demodulatable light groups Cycles exposes.
LIGHT_GROUPS: Tuple[str, ...] = ("diffuse", "glossy", "subsurface", "transmission")

# Convention for the 'normal' pass y component, pinned in ONE place so the
# augmentation vector fixup, the Blender export scripts, and any future
# ingest agree: Cycles camera-space normals are Y-UP (+y points toward the
# top of the image), while numpy image rows grow downward. Geometric
# consistency under rotation is asserted by
# tests/test_pipeline_data.py::test_augment_normal_geometry_consistent.
NORMAL_Y_UP: bool = True


@dataclasses.dataclass(frozen=True)
class RenderPass:
    """Static metadata for one render pass."""

    name: str
    channels: int
    kind: PassKind
    role: Role
    group: Optional[str] = None  # one of LIGHT_GROUPS or None

    @property
    def is_hdr(self) -> bool:
        return self.kind in (PassKind.RADIANCE, PassKind.DEPTH)

    @property
    def in_recomposition(self) -> bool:
        """Whether this pass participates in the recomposition sum."""
        return self.role in (Role.DIRECT, Role.INDIRECT, Role.COLOR) or self.name in (
            "emission",
            "environment",
        )


def _build_registry() -> Dict[str, RenderPass]:
    reg: Dict[str, RenderPass] = {}

    def add(p: RenderPass) -> None:
        reg[p.name] = p

    add(RenderPass("combined", 3, PassKind.RADIANCE, Role.COMPOSITE))
    for g in LIGHT_GROUPS:
        add(RenderPass(f"{g}_direct", 3, PassKind.RADIANCE, Role.DIRECT, group=g))
        add(RenderPass(f"{g}_indirect", 3, PassKind.RADIANCE, Role.INDIRECT, group=g))
        add(RenderPass(f"{g}_color", 3, PassKind.COLOR, Role.COLOR, group=g))
    add(RenderPass("emission", 3, PassKind.RADIANCE, Role.COMPOSITE))
    add(RenderPass("environment", 3, PassKind.RADIANCE, Role.COMPOSITE))
    add(RenderPass("normal", 3, PassKind.NORMAL, Role.AUX))
    add(RenderPass("depth", 1, PassKind.DEPTH, Role.AUX))
    add(RenderPass("alpha", 1, PassKind.ALPHA, Role.AUX))
    return reg


REGISTRY: Dict[str, RenderPass] = _build_registry()

# Canonical orderings used everywhere a pass set is flattened to channels.
ALL_PASSES: Tuple[str, ...] = tuple(REGISTRY)
AUX_PASSES: Tuple[str, ...] = ("normal", "depth", "alpha")
COMPOSITE_EXTRA: Tuple[str, ...] = ("emission", "environment")


def get(name: str) -> RenderPass:
    try:
        return REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown render pass {name!r}; known: {sorted(REGISTRY)}") from e


def channels(name: str) -> int:
    return get(name).channels


def group_passes(group: str) -> Tuple[str, str, str]:
    """(direct, indirect, color) pass names for a light group."""
    if group not in LIGHT_GROUPS:
        raise KeyError(f"unknown light group {group!r}; known: {LIGHT_GROUPS}")
    return (f"{group}_direct", f"{group}_indirect", f"{group}_color")


def recomposition_terms(groups: Sequence[str] = LIGHT_GROUPS) -> List[Tuple[str, str, str]]:
    """Terms of `combined = Σ color ⊙ (direct + indirect) + emission + environment`."""
    return [group_passes(g) for g in groups]


# ---------------------------------------------------------------------------
# Canonical naming (upstream: TensorFlow/Naming.py — SURVEY.md C2)
# ---------------------------------------------------------------------------

SOURCE = "source"
TARGET = "target"
PREDICTION = "prediction"


def feature_name(pass_name: str, role: str = SOURCE, index: int = 0) -> str:
    """Canonical dict key for a tensor: datasets, model, and losses agree on it.

    `index` distinguishes multiple noise realizations of the same source pass.
    """
    get(pass_name)  # validate
    if role == SOURCE:
        return f"{SOURCE}/{pass_name}/{index}"
    if role in (TARGET, PREDICTION):
        return f"{role}/{pass_name}"
    raise ValueError(f"unknown role {role!r}")


def parse_feature_name(key: str) -> Tuple[str, str, int]:
    """Inverse of feature_name -> (pass_name, role, index)."""
    parts = key.split("/")
    if parts[0] == SOURCE and len(parts) == 3:
        return parts[1], SOURCE, int(parts[2])
    if parts[0] in (TARGET, PREDICTION) and len(parts) == 2:
        return parts[1], parts[0], 0
    raise ValueError(f"unparseable feature name {key!r}")


# ---------------------------------------------------------------------------
# Feature flags (upstream: TensorFlow/FeatureFlags.py — SURVEY.md C3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureFlags:
    """Which passes are present/enabled for an example set.

    Scenes may lack some passes (e.g. no subsurface). The flags select the
    active light groups and aux features, and can be encoded as constant
    mask channels (transforms.encode_flag_channels) for networks trained
    across heterogeneous pass sets.
    """

    groups: Tuple[str, ...] = LIGHT_GROUPS
    use_normal: bool = True
    use_depth: bool = True
    use_alpha: bool = True

    def __post_init__(self) -> None:
        for g in self.groups:
            if g not in LIGHT_GROUPS:
                raise KeyError(f"unknown light group {g!r}")

    @property
    def aux_passes(self) -> Tuple[str, ...]:
        used = (("normal", self.use_normal), ("depth", self.use_depth), ("alpha", self.use_alpha))
        return tuple(name for name, on in used if on)

    @property
    def aux_channels(self) -> int:
        return sum(channels(p) for p in self.aux_passes)

    def mask_bits(self) -> Tuple[int, ...]:
        """Stable bit vector (one per LIGHT_GROUPS entry + 3 aux) for encoding
        the active feature set as constant channels."""
        bits = [1 if g in self.groups else 0 for g in LIGHT_GROUPS]
        bits += [int(self.use_normal), int(self.use_depth), int(self.use_alpha)]
        return tuple(bits)
