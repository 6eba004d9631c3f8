"""Voronoi holdout family for de-circularized quality evaluation.

A numpy copy of deepdenoiser_tpu/data/synthetic_holdout.py, bit-equal to
it for every seed, built on the port's passes and data/synthetic.py so
nothing of the JAX package is imported. What follows is the original's
account of the family.

The training distribution (data/synthetic.py and its on-device twin
synthetic_device.py) is built from band-limited random FOURIER fields; a model
evaluated on the same family proves little (VERDICT r1 weak #3). This
module is a structurally DIFFERENT generative family — no Fourier fields
anywhere:

  * geometry: a random Voronoi partition into K cells — piecewise-CONSTANT
    albedo with hard edges (the texture detail case albedo demodulation
    exists for), per-cell planar depth with discontinuities at cell
    borders, per-cell base normals + high-frequency bump texture;
  * illumination: a directional light with Lambert shading and a soft
    shadow band (area-light penumbra), plus a blurred ambient bounce as
    the indirect term — illumination correlates with geometry, unlike the
    training family's independent random fields;
  * emission from a few emissive cells; environment as a vertical sky
    gradient.

Same pass contract as data/synthetic.py (upstream data model: SURVEY.md
C19/N5): the recomposition identity holds exactly; aux buffers are
noise-free. Reuse synthetic.add_mc_noise for noisy realizations — the
NOISE model stays identical so holdout deltas isolate the SIGNAL family.

Used by the tools and the tests. This family is eval-only: nothing
here is imported by any training path.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.data.synthetic import recompose_np
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS


def _voronoi(rng: np.random.Generator, h: int, w: int, k: int) -> np.ndarray:
    """(h, w) int32 nearest-site labels — hard cell edges."""
    pts = np.stack(
        [rng.uniform(0, h, size=k), rng.uniform(0, w, size=k)], axis=-1
    ).astype(np.float32)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    labels = np.zeros((h, w), np.int32)
    best = np.full((h, w), np.inf, np.float32)
    for i in range(k):
        d = (yy - pts[i, 0]) ** 2 + (xx - pts[i, 1]) ** 2
        m = d < best
        labels[m] = i
        best[m] = d[m]
    return labels


def _box_blur(img: np.ndarray, r: int) -> np.ndarray:
    """Separable box blur with edge clamping via cumulative sums (no FFT)."""
    if r <= 0:
        return img
    out = img.astype(np.float32)
    for axis in (0, 1):
        n = out.shape[axis]
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r + 1, r)
        p = np.pad(out, pad, mode="edge")
        c = np.cumsum(p, axis=axis)
        hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
        lo = np.take(c, np.arange(0, n), axis=axis)
        out = (hi - lo) / (2 * r + 1)
    return out


def generate_clean_passes(
    height: int,
    width: int,
    seed: int = 0,
    groups: Sequence[str] = LIGHT_GROUPS,
    n_cells: int = 24,
    light_scale: float = 4.0,
) -> Dict[str, np.ndarray]:
    """Ground-truth holdout pass set, recomposition-consistent."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    labels = _voronoi(rng, height, width, n_cells)
    onehot = labels  # index arrays below

    # --- geometry -----------------------------------------------------
    # Per-cell base normals biased toward the camera (+z), plus a
    # high-frequency bump texture (blurred white noise, NOT Fourier).
    base_n = rng.normal(size=(n_cells, 3)).astype(np.float32)
    base_n[:, 2] = np.abs(base_n[:, 2]) + 1.5
    base_n /= np.linalg.norm(base_n, axis=-1, keepdims=True)
    bump = _box_blur(rng.standard_normal((height, width, 3)).astype(np.float32), 1)
    n = base_n[onehot] + 0.15 * bump
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    out["normal"] = n.astype(np.float32)

    # Per-cell planar depth: discontinuities at every cell border.
    yy = np.linspace(-0.5, 0.5, height, dtype=np.float32)[:, None]
    xx = np.linspace(-0.5, 0.5, width, dtype=np.float32)[None, :]
    d0 = rng.uniform(2.0, 30.0, size=n_cells).astype(np.float32)
    gy = rng.uniform(-8.0, 8.0, size=n_cells).astype(np.float32)
    gx = rng.uniform(-8.0, 8.0, size=n_cells).astype(np.float32)
    depth = d0[onehot] + gy[onehot] * yy + gx[onehot] * xx
    out["depth"] = np.maximum(depth, 0.05)[..., None].astype(np.float32)

    # A couple of cells are see-through (alpha dip with a feathered edge).
    see_through = rng.random(n_cells) < 0.12
    alpha = 1.0 - 0.6 * see_through[onehot].astype(np.float32)
    # clip: cumsum-blur float error can push values epsilon past the bounds
    out["alpha"] = np.clip(_box_blur(alpha[..., None], 2), 0.0, 1.0).astype(np.float32)

    # --- illumination (shared across groups, scaled per group) ---------
    light = rng.normal(size=3).astype(np.float32)
    light[2] = abs(light[2]) + 1.0
    light /= np.linalg.norm(light)
    lambert = np.maximum((n * light).sum(-1), 0.0)[..., None]  # (h, w, 1)
    # Soft shadow: a random half-plane occluder, box-blurred into a penumbra.
    sy, sx = rng.normal(size=2).astype(np.float32)
    c = rng.uniform(-0.2, 0.2)
    occluded = ((sy * yy + sx * xx + c) > 0).astype(np.float32)
    penumbra = max(3, min(height, width) // 24)
    vis = 1.0 - 0.85 * _box_blur(occluded[..., None], penumbra)
    # Ambient bounce: blurred lambert — smooth, geometry-correlated.
    bounce = _box_blur(lambert, max(4, min(height, width) // 12))

    # --- per-group albedo + radiance -----------------------------------
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        cell_col = rng.uniform(0.05, 0.95, size=(n_cells, 3)).astype(np.float32)
        # some near-black cells exercise the demodulation epsilon guards
        dark = rng.random(n_cells) < 0.1
        cell_col[dark] *= 0.01
        out[c_name] = cell_col[onehot]

        tint_d = rng.uniform(0.5, 1.5, size=3).astype(np.float32)
        tint_i = rng.uniform(0.2, 0.8, size=3).astype(np.float32)
        intensity = light_scale * rng.uniform(0.3, 1.0)
        out[d_name] = (intensity * lambert * vis * tint_d).astype(np.float32)
        out[i_name] = (0.5 * intensity * bounce * tint_i).astype(np.float32)

    # --- emission / environment ----------------------------------------
    emissive = rng.random(n_cells) < 0.08
    em_col = rng.uniform(0.5, 3.0, size=(n_cells, 3)).astype(np.float32)
    em_col[~emissive] = 0.0
    out["emission"] = em_col[onehot]
    sky_top = rng.uniform(0.02, 0.3, size=3).astype(np.float32)
    sky_bot = rng.uniform(0.0, 0.1, size=3).astype(np.float32)
    t = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    out["environment"] = np.broadcast_to(
        (1 - t) * sky_top + t * sky_bot, (height, width, 3)
    ).astype(np.float32)

    out["combined"] = recompose_np(out, groups)
    return out


def generate_frame_set(
    height: int,
    width: int,
    seed: int,
    spps: Sequence[int] = (4, 16),
    n_seeds: int = 2,
    groups: Sequence[str] = LIGHT_GROUPS,
) -> Tuple[Dict[str, np.ndarray], list]:
    """(clean, [noisy...]) — same contract as synthetic.generate_frame_set,
    same MC noise model (synthetic.add_mc_noise), different signal family."""
    from deepdenoiser_tpu_torch.data import synthetic

    clean = generate_clean_passes(height, width, seed=seed, groups=groups)
    noisy = [
        synthetic.add_mc_noise(clean, spp=spp, seed=seed * 1000 + 97 * k + spp,
                               groups=groups)
        for spp in spps
        for k in range(n_seeds)
    ]
    return clean, noisy
