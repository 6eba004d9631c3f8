"""Spheres holdout family — the round-3 UNTOUCHED quality holdout.

A numpy copy of deepdenoiser_tpu/data/synthetic_spheres.py, bit-equal to
it for every seed, built on the port's passes and data/synthetic.py so
nothing of the JAX package is imported.

Round 2 de-circularized quality with a Voronoi holdout family
(data/synthetic_holdout.py) and found real memorization. Round 3 promotes
Voronoi into the training corpus (data/synthetic_device.py family='mixed'),
so the holdout must move to a THIRD structurally new family (VERDICT r2
item 1). This module is that family — a tiny analytic ray-traced scene,
structurally unlike both Fourier fields and Voronoi cells:

  * geometry: N random spheres above an infinite ground plane, viewed by
    a perspective camera — CURVED surfaces (quadratic normal variation),
    occlusion silhouettes, a true perspective depth field;
  * albedo: procedural CHECKERBOARD on the ground plane and per-sphere
    solid/striped colors — axis-aligned high-frequency texture detail
    (the case albedo demodulation exists for), unlike the cell-constant
    Voronoi albedo and the smooth Fourier albedo;
  * direct light: a directional sun with analytic ray-traced HARD shadows
    (sphere occlusion tests toward the light);
  * indirect: sky-dome ambient scaled by an up-facing term plus a ground
    bounce tint — geometry-correlated, not a blurred copy of direct;
  * environment: visible sky gradient where rays miss; alpha = coverage.

Same pass contract as data/synthetic.py (upstream data model: SURVEY.md
C19/N5): the recomposition identity holds exactly, aux buffers are noise
free, and noisy realizations reuse synthetic.add_mc_noise so the NOISE
model is identical across families — holdout deltas isolate the SIGNAL
family.

Eval-only: used by the tools and the tests; never by any training
path.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.data.synthetic import recompose_np
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS


def _ray_sphere(origin: np.ndarray, dirs: np.ndarray, center: np.ndarray,
                radius: float) -> np.ndarray:
    """Smallest positive hit distance per ray, +inf on miss.

    origin (3,), dirs (..., 3) unit, center (3,)."""
    oc = origin - center
    b = (dirs * oc).sum(-1)
    c = (oc * oc).sum() - radius * radius
    disc = b * b - c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = -b - sq, -b + sq
    t = np.where(t0 > 1e-4, t0, t1)
    return np.where((disc > 0) & (t > 1e-4), t, np.inf).astype(np.float32)


def _checker(p: np.ndarray, scale: float) -> np.ndarray:
    """(..., 3) world points -> (...,) {0,1} checkerboard on x/z."""
    return ((np.floor(p[..., 0] * scale) + np.floor(p[..., 2] * scale)) % 2
            ).astype(np.float32)


def generate_clean_passes(
    height: int,
    width: int,
    seed: int = 0,
    groups: Sequence[str] = LIGHT_GROUPS,
    n_spheres: int = 7,
    light_scale: float = 4.0,
) -> Dict[str, np.ndarray]:
    """Ground-truth spheres pass set, recomposition-consistent."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    # --- camera rays ------------------------------------------------------
    aspect = width / height
    fov = 0.9  # ~51 deg vertical
    yy = np.linspace(1.0, -1.0, height, dtype=np.float32)[:, None]
    xx = np.linspace(-aspect, aspect, width, dtype=np.float32)[None, :]
    origin = np.array([0.0, 1.5, 0.0], np.float32)
    dirs = np.stack(
        [np.broadcast_to(xx * fov, (height, width)),
         np.broadcast_to(yy * fov, (height, width)),
         np.full((height, width), 1.0, np.float32)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    # --- scene ------------------------------------------------------------
    centers = np.stack([
        rng.uniform(-4.0, 4.0, n_spheres),
        rng.uniform(0.4, 2.5, n_spheres),
        rng.uniform(4.0, 12.0, n_spheres),
    ], axis=-1).astype(np.float32)
    radii = rng.uniform(0.4, 1.4, n_spheres).astype(np.float32)
    centers[:, 1] = np.maximum(centers[:, 1], radii * 0.6)

    # nearest hit: ground plane y=0 then spheres
    denom = dirs[..., 1]
    t_plane = np.where(denom < -1e-6, -origin[1] / np.minimum(denom, -1e-6),
                       np.inf).astype(np.float32)
    t_best = t_plane
    hit_id = np.where(np.isfinite(t_plane), -1, -2)  # -1 plane, -2 sky
    for i in range(n_spheres):
        t = _ray_sphere(origin, dirs, centers[i], radii[i])
        m = t < t_best
        t_best = np.where(m, t, t_best)
        hit_id = np.where(m, i, hit_id)
    hit = hit_id >= -1
    t_safe = np.where(np.isfinite(t_best), t_best, 50.0).astype(np.float32)
    points = origin + dirs * t_safe[..., None]

    # --- geometry buffers -------------------------------------------------
    normal = np.zeros((height, width, 3), np.float32)
    normal[..., 1] = 1.0  # plane default
    for i in range(n_spheres):
        m = hit_id == i
        n_i = (points - centers[i]) / radii[i]
        normal[m] = n_i[m]
    sky = hit_id == -2
    normal[sky] = np.array([0.0, 0.0, -1.0], np.float32)  # facing camera
    # screen-space convention: z toward camera
    view_n = np.stack([normal[..., 0], normal[..., 1], -normal[..., 2]],
                      axis=-1)
    view_n /= np.maximum(np.linalg.norm(view_n, axis=-1, keepdims=True), 1e-6)
    out["normal"] = view_n.astype(np.float32)
    out["depth"] = np.where(hit, t_safe, 50.0)[..., None].astype(np.float32)
    out["alpha"] = hit[..., None].astype(np.float32)

    # --- direct light with ray-traced hard shadows ------------------------
    light = rng.normal(size=3).astype(np.float32)
    light[1] = abs(light[1]) + 1.5
    light /= np.linalg.norm(light)
    lambert = np.maximum((normal * light).sum(-1), 0.0)
    shadow = np.ones((height, width), np.float32)
    for i in range(n_spheres):
        # occlusion of the shadow ray from each surface point toward light
        oc = points - centers[i]
        b = (oc * light).sum(-1)
        c = (oc * oc).sum(-1) - radii[i] ** 2
        disc = b * b - c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_hit = -b - sq
        occ = (disc > 0) & (t_hit > 1e-3) & (hit_id != i)
        shadow = np.where(occ, 0.0, shadow)
    direct_term = (lambert * shadow * hit)[..., None]

    # --- indirect: sky ambient by up-facing + ground bounce ---------------
    up_term = (0.5 + 0.5 * normal[..., 1])[..., None]
    bounce = np.exp(-0.4 * np.maximum(points[..., 1], 0.0))[..., None]
    indirect_term = (0.4 * up_term + 0.25 * bounce) * hit[..., None]

    # --- per-group albedo + radiance --------------------------------------
    plane_a = rng.uniform(0.1, 0.9, size=(2, 3)).astype(np.float32)
    check = _checker(points, rng.uniform(0.6, 1.4))[..., None]
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        sph_col = rng.uniform(0.05, 0.95, size=(n_spheres, 3)).astype(np.float32)
        dark = rng.random(n_spheres) < 0.12
        sph_col[dark] *= 0.01
        stripe_scale = rng.uniform(4.0, 9.0)
        albedo = plane_a[0] * check + plane_a[1] * (1 - check)
        for i in range(n_spheres):
            m = hit_id == i
            stripes = 0.5 + 0.5 * np.sign(
                np.sin(stripe_scale * (points[..., 1] - centers[i, 1]) / radii[i])
            )[..., None].astype(np.float32)
            col = sph_col[i] * (0.6 + 0.4 * stripes)
            albedo = np.where(m[..., None], col, albedo)
        albedo = np.where(hit[..., None], albedo, 0.0)
        out[c_name] = albedo.astype(np.float32)

        tint_d = rng.uniform(0.6, 1.4, size=3).astype(np.float32)
        tint_i = rng.uniform(0.2, 0.8, size=3).astype(np.float32)
        intensity = light_scale * rng.uniform(0.3, 1.0)
        out[d_name] = (intensity * direct_term * tint_d).astype(np.float32)
        out[i_name] = (0.7 * intensity * indirect_term * tint_i).astype(np.float32)

    # --- emission / environment -------------------------------------------
    em = np.zeros((height, width, 3), np.float32)
    if n_spheres > 0 and rng.random() < 0.5:
        i = int(rng.integers(n_spheres))
        em_col = rng.uniform(1.0, 4.0, size=3).astype(np.float32)
        em[hit_id == i] = em_col
    out["emission"] = em
    sky_top = rng.uniform(0.1, 0.5, size=3).astype(np.float32)
    sky_hor = rng.uniform(0.3, 0.8, size=3).astype(np.float32)
    tsky = np.clip(dirs[..., 1:2] * 1.5 + 0.2, 0.0, 1.0)
    env = (tsky * sky_top + (1 - tsky) * sky_hor) * (~hit)[..., None]
    out["environment"] = env.astype(np.float32)

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
    """(clean, [noisy...]) — same contract and NOISE model as
    synthetic.generate_frame_set; only the signal family differs."""
    from deepdenoiser_tpu_torch.data import synthetic

    clean = generate_clean_passes(height, width, seed=seed, groups=groups)
    noisy = [
        synthetic.add_mc_noise(clean, spp=spp, seed=seed * 1000 + 97 * k + spp,
                               groups=groups)
        for spp in spps
        for k in range(n_seeds)
    ]
    return clean, noisy
