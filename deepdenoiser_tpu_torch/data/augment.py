"""Geometric augmentation applied identically to every pass of an example
(upstream: TensorFlow/DataAugmentation.py — SURVEY.md C8): random H/V flips
and 90° rotations — the dihedral group D4. A copy of
deepdenoiser_tpu/data/augment.py: the same rng gives the same example.

Correctness detail the reference glosses over: screen-space NORMALS are
vectors, not colors. A horizontal flip negates the x component, a vertical
flip negates y, and a 90° rotation rotates (x, y). Applying D4 to normal
maps without the vector fixup teaches the network wrong geometry cues.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from deepdenoiser_tpu_torch import passes


def d4_params(rng: np.random.Generator) -> Tuple[int, bool]:
    """(k rotations by 90°, horizontal flip?) — uniform over the 8 elements."""
    return int(rng.integers(0, 4)), bool(rng.integers(0, 2))


def apply_d4(arr: np.ndarray, k: int, flip: bool, is_normal: bool) -> np.ndarray:
    """Apply rot90^k then optional horizontal flip to an HWC array.

    For normal passes the (x, y) vector components are transformed with the
    same isometry. The normal pass stores Cycles camera-space normals, whose
    y component is Y-UP (passes.NORMAL_Y_UP) while numpy rows grow downward:
    np.rot90 (CCW in array axes) therefore maps a y-up vector
    (x, y) -> (-y, x); a horizontal flip negates x either way. Asserted
    geometrically (normals of a rotated height field) in
    the JAX package's tests (test_augment_normal_geometry_consistent).
    """
    k = k % 4
    out = np.rot90(arr, k, axes=(0, 1)) if k else arr
    if flip:
        out = out[:, ::-1]
    if is_normal and (k or flip):
        # One closed-form rotation instead of k sequential swaps. y-up:
        # one CCW array rotation maps (x, y)->(-y, x), i.e. θ=+90°; k
        # steps compose to θ=k·90°.
        out = out.copy()
        c, s = ((1, 0), (0, 1), (-1, 0), (0, -1))[k]
        if not passes.NORMAL_Y_UP:
            s = -s
        x, y = out[..., 0].copy(), out[..., 1].copy()
        out[..., 0] = c * x - s * y
        out[..., 1] = s * x + c * y
        if flip:
            out[..., 0] = -out[..., 0]
    # No ascontiguousarray: rows may be rot90/flip views; the loader's
    # batch np.stack makes the one copy needed.
    return out


def augment_example(
    example: Mapping[str, np.ndarray], rng: np.random.Generator
) -> Dict[str, np.ndarray]:
    """One random D4 element applied to every '<role>/<pass>' array."""
    k, flip = d4_params(rng)
    out = {}
    for key, arr in example.items():
        if "/" not in key:  # non-spatial metadata (e.g. 'flags') passes through
            out[key] = arr
            continue
        pass_name = key.split("/")[1]
        is_normal = passes.get(pass_name).kind is passes.PassKind.NORMAL
        out[key] = apply_d4(arr, k, flip, is_normal)
    return out
