"""Boxes holdout family — the round-4 SECOND untouched quality holdout.

A numpy copy of deepdenoiser_tpu/data/synthetic_boxes.py, bit-equal to
it for every seed, built on the port's passes and data/synthetic.py so
nothing of the JAX package is imported.

VERDICT r3 (missing #3): three rounds of checkpoint selection were
arbitrated by exactly one never-trained family (analytic spheres,
data/synthetic_spheres.py); a single holdout erodes each round it steers
a shipping decision. This module is a FOURTH signal family, eval-only,
structurally different from all three existing ones along axes none of
them covers:

  * geometry: y-rotated boxes (OBBs, slab-test ray tracing) on a ground
    plane — piecewise-CONSTANT face normals with straight diagonal
    silhouettes (spheres have quadratically varying normals; Fourier and
    Voronoi have no 3-D geometry at all);
  * direct light: a disk AREA light sampled with a fixed stratified grid
    → analytic-quality SOFT shadows with wide penumbra gradients (the
    spheres family has hard binary shadows; penumbrae appear nowhere
    else in the corpus);
  * albedo: smooth multi-sine "marble" texture warped by a nested sine
    (not the cell-constant Voronoi albedo, not the checkerboard/stripe
    spheres albedo, and — critically — TEXTURED detail riding on flat
    geometry, the demodulation stress case);
  * indirect: up-facing sky term plus a contact-darkening term (soft
    ambient occlusion toward box bases) — geometry-correlated in a way
    the other families' indirect is not.

Same pass contract as data/synthetic.py (upstream data model: SURVEY.md
C19/N5): recomposition identity holds exactly, aux buffers are noise
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


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def _ray_box(origin: np.ndarray, dirs: np.ndarray, center: np.ndarray,
             half: np.ndarray, rot: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Slab-test ray/OBB intersection.

    origin (..., 3) or (3,), dirs (..., 3) unit, center (3,), half (3,)
    extents, rot (3, 3) box->world rotation. Returns (t, axis): smallest
    positive hit distance (+inf on miss) and the local slab axis hit
    (0/1/2), used for the face normal.
    """
    # into box frame: p_local = R^T (p - c)
    o = (origin - center) @ rot  # (..., 3)
    d = dirs @ rot
    d_safe = np.where(np.abs(d) < 1e-9, 1e-9, d)
    t1 = (-half - o) / d_safe
    t2 = (half - o) / d_safe
    tmin = np.minimum(t1, t2)  # (..., 3) per-slab entry
    tmax = np.maximum(t1, t2)
    t_near = tmin.max(-1)
    t_far = tmax.min(-1)
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t = np.where(t_near > 1e-4, t_near, t_far)  # allow origins inside
    t = np.where(hit, t, np.inf).astype(np.float32)
    axis = tmin.argmax(-1)
    return t, axis


def _marble(p: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(..., 3) world points -> (...,) [0,1] smooth warped-sine texture."""
    k1 = rng.uniform(1.5, 3.5, size=3).astype(np.float32)
    k2 = rng.uniform(3.0, 7.0, size=3).astype(np.float32)
    warp_amp = rng.uniform(1.0, 2.5)
    phase = rng.uniform(0.0, 2 * np.pi)
    warp = np.sin((p * k2).sum(-1) + phase)
    return (0.5 + 0.5 * np.sin((p * k1).sum(-1) + warp_amp * warp)
            ).astype(np.float32)


def _disk_light_dirs(light: np.ndarray, radius: float,
                     rng: np.random.Generator, n: int = 4) -> np.ndarray:
    """(n*n, 3) unit directions toward a disk area light around `light`.

    Fixed stratified grid with one frame-constant jitter per cell — the
    sample set is deterministic per frame, so the penumbra it defines IS
    the clean signal (band-limited shadow gradients), not residual noise.
    """
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(light @ up)) > 0.9:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    u = np.cross(light, up)
    u /= np.linalg.norm(u)
    v = np.cross(light, u)
    ij = (np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1)
          .reshape(-1, 2).astype(np.float32))
    jit = rng.uniform(0.2, 0.8, size=ij.shape).astype(np.float32)
    sq = (ij + jit) / n * 2.0 - 1.0  # (-1,1)^2
    # concentric-ish: keep samples inside the unit disk
    r = np.sqrt(sq[:, 0] ** 2 + sq[:, 1] ** 2)
    scale = np.where(r > 1.0, 1.0 / np.maximum(r, 1e-6), 1.0)[:, None]
    sq = sq * scale
    d = (light[None, :] + radius * (sq[:, :1] * u + sq[:, 1:2] * v))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def generate_clean_passes(
    height: int,
    width: int,
    seed: int = 0,
    groups: Sequence[str] = LIGHT_GROUPS,
    n_boxes: int = 6,
    light_scale: float = 4.0,
    shadow_samples: int = 4,
) -> Dict[str, np.ndarray]:
    """Ground-truth boxes pass set, recomposition-consistent."""
    rng = np.random.default_rng(seed + 77_000)
    out: Dict[str, np.ndarray] = {}

    # --- camera rays ------------------------------------------------------
    aspect = width / height
    fov = 0.9
    yy = np.linspace(1.0, -1.0, height, dtype=np.float32)[:, None]
    xx = np.linspace(-aspect, aspect, width, dtype=np.float32)[None, :]
    origin = np.array([0.0, 1.8, 0.0], np.float32)
    dirs = np.stack(
        [np.broadcast_to(xx * fov, (height, width)),
         np.broadcast_to(yy * fov, (height, width)),
         np.full((height, width), 1.0, np.float32)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    # --- scene: y-rotated boxes resting on / hovering near the plane ------
    halves = np.stack([
        rng.uniform(0.3, 1.2, n_boxes),
        rng.uniform(0.3, 1.6, n_boxes),
        rng.uniform(0.3, 1.2, n_boxes),
    ], axis=-1).astype(np.float32)
    centers = np.stack([
        rng.uniform(-4.5, 4.5, n_boxes),
        halves[:, 1] + rng.uniform(0.0, 0.6, n_boxes),
        rng.uniform(4.0, 12.0, n_boxes),
    ], axis=-1).astype(np.float32)
    rots = [_rot_y(rng.uniform(0.0, np.pi / 2)) for _ in range(n_boxes)]

    denom = dirs[..., 1]
    t_plane = np.where(denom < -1e-6, -origin[1] / np.minimum(denom, -1e-6),
                       np.inf).astype(np.float32)
    t_best = t_plane
    hit_id = np.where(np.isfinite(t_plane), -1, -2)  # -1 plane, -2 sky
    hit_axis = np.zeros((height, width), np.int64)
    for i in range(n_boxes):
        t, axis = _ray_box(origin, dirs, centers[i], halves[i], rots[i])
        m = t < t_best
        t_best = np.where(m, t, t_best)
        hit_id = np.where(m, i, hit_id)
        hit_axis = np.where(m, axis, hit_axis)
    hit = hit_id >= -1
    t_safe = np.where(np.isfinite(t_best), t_best, 50.0).astype(np.float32)
    points = origin + dirs * t_safe[..., None]

    # --- geometry buffers: piecewise-constant face normals -----------------
    normal = np.zeros((height, width, 3), np.float32)
    normal[..., 1] = 1.0  # plane default
    for i in range(n_boxes):
        m = hit_id == i
        if not m.any():
            continue
        local = (points - centers[i]) @ rots[i]
        for ax in range(3):
            ma = m & (hit_axis == ax)
            if not ma.any():
                continue
            sign = np.sign(local[..., ax])[..., None]
            n_world = sign * rots[i][:, ax][None, None, :]
            normal[ma] = n_world[ma]
    sky = hit_id == -2
    normal[sky] = np.array([0.0, 0.0, -1.0], np.float32)
    view_n = np.stack([normal[..., 0], normal[..., 1], -normal[..., 2]],
                      axis=-1)
    view_n /= np.maximum(np.linalg.norm(view_n, axis=-1, keepdims=True), 1e-6)
    out["normal"] = view_n.astype(np.float32)
    out["depth"] = np.where(hit, t_safe, 50.0)[..., None].astype(np.float32)
    out["alpha"] = hit[..., None].astype(np.float32)

    # --- direct light: disk area light -> SOFT shadows ---------------------
    light = rng.normal(size=3).astype(np.float32)
    light[1] = abs(light[1]) + 1.2
    light /= np.linalg.norm(light)
    lam_dirs = _disk_light_dirs(light, rng.uniform(0.15, 0.35), rng,
                                n=shadow_samples)
    shadow_origin = points + normal * 1e-3
    vis = np.zeros((height, width), np.float32)
    for ld in lam_dirs:
        v = np.ones((height, width), np.float32)
        ld_b = np.broadcast_to(ld, (height, width, 3))
        for i in range(n_boxes):
            t, _ = _ray_box(shadow_origin, ld_b, centers[i], halves[i],
                            rots[i])
            v = np.where(np.isfinite(t), 0.0, v)
        vis += v
    vis /= len(lam_dirs)
    lambert = np.maximum((normal * light).sum(-1), 0.0)
    direct_term = (lambert * vis * hit)[..., None]

    # --- indirect: sky ambient + contact darkening (soft AO) --------------
    up_term = (0.5 + 0.5 * normal[..., 1])[..., None]
    ao = np.ones((height, width), np.float32)
    for i in range(n_boxes):
        # darken near each box's footprint, falling off with distance
        d = np.linalg.norm(points - centers[i], axis=-1)
        reach = float(np.linalg.norm(halves[i])) + 0.8
        ao *= 1.0 - 0.45 * np.clip(1.0 - d / reach, 0.0, 1.0)
    indirect_term = (0.45 * up_term * ao[..., None]) * hit[..., None]

    # --- per-group albedo + radiance --------------------------------------
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        box_col = rng.uniform(0.05, 0.95, size=(n_boxes, 3)).astype(np.float32)
        dark = rng.random(n_boxes) < 0.12
        box_col[dark] *= 0.01
        plane_c0 = rng.uniform(0.1, 0.9, size=3).astype(np.float32)
        plane_c1 = rng.uniform(0.1, 0.9, size=3).astype(np.float32)
        tex = _marble(points, rng)[..., None]
        albedo = plane_c0 * tex + plane_c1 * (1 - tex)
        for i in range(n_boxes):
            m = hit_id == i
            if not m.any():
                continue
            btex = _marble((points - centers[i]) @ rots[i], rng)[..., None]
            col = box_col[i] * (0.4 + 0.6 * btex)
            albedo = np.where(m[..., None], col, albedo)
        albedo = np.where(hit[..., None], albedo, 0.0)
        out[c_name] = albedo.astype(np.float32)

        tint_d = rng.uniform(0.6, 1.4, size=3).astype(np.float32)
        tint_i = rng.uniform(0.2, 0.8, size=3).astype(np.float32)
        intensity = light_scale * rng.uniform(0.3, 1.0)
        out[d_name] = (intensity * direct_term * tint_d).astype(np.float32)
        out[i_name] = (0.7 * intensity * indirect_term * tint_i
                       ).astype(np.float32)

    # --- emission / environment -------------------------------------------
    em = np.zeros((height, width, 3), np.float32)
    if n_boxes > 0 and rng.random() < 0.5:
        i = int(rng.integers(n_boxes))
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
