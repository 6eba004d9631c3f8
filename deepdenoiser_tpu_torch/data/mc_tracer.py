"""Genuine Monte-Carlo render passes from a small path tracer on the card.

The port of deepdenoiser_tpu/data/mc_tracer.py. Random spheres over a
checkered ground plane, lit by a disk area light and a sky:

  * primary visibility is deterministic (pixel-centre rays), so the aux
    buffers (normal, depth, alpha, albedo) and emission/environment are
    noise-free, as in Cycles;
  * DIRECT light: one uniform sample of the disk light per sample, with a
    traced shadow ray, so the noise follows the penumbrae;
  * INDIRECT light: one cosine-hemisphere ray per sample: sky radiance on
    a miss, emission plus one-bounce direct light on a hit. A bright
    emissive sphere makes rare high-energy samples: real fireflies;
  * the ground truth is the same estimator at a high sample count.

The four light groups share one traced estimate pair with per-group
tints, and `combined` is recomposed from the traced passes, so the
recomposition identity holds for clean and noisy frames alike.

Every random number comes from a draw source (data/draws.py) in the
order the JAX tracer draws it: per sample, the direct light's disk point
(r, then phi), then the indirect ray's cosine direction (u1, u2) and its
bounce's disk point. `render` takes one scene, or a batch of scenes
(every Scene field with a leading batch dimension) with one window
origin each; the spheres are a vectorised axis, not a Python loop.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.data.draws import Draws, seeded
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS

Tensor = torch.Tensor

DEFAULT_GT_SPP = 1024


class Scene(NamedTuple):
    """One scene, or a batch of B scenes with a leading B on every field."""

    centers: Tensor        # (N, 3) sphere centres
    radii: Tensor          # (N,)
    sphere_albedo: Tensor  # (N, 3) diffuse-group albedo (bounce shading)
    emission: Tensor       # (N, 3) emitted radiance (mostly zero; fireflies)
    plane_albedo: Tensor   # (2, 3) checker colours
    checker_scale: Tensor  # ()
    light_center: Tensor   # (3,) disk area light centre
    light_radius: Tensor   # ()
    light_normal: Tensor   # (3,) unit, points toward the scene
    light_radiance: Tensor # (3,)
    sky_top: Tensor        # (3,)
    sky_hor: Tensor        # (3,)
    group_tint_d: Tensor   # (G, 3) per-group direct tint
    group_tint_i: Tensor   # (G, 3) per-group indirect tint
    group_albedo_mix: Tensor  # (G,) blend between shared albedo and flat grey


def make_scene(seed: int, n_spheres: int = 7, groups: Sequence[str] = LIGHT_GROUPS,
               device: Optional[Union[str, torch.device]] = None) -> Scene:
    """Draw a random scene with numpy's RNG (the families' seed contract):
    bit-equal to the JAX package's make_scene, as tensors on `device` (the
    card unless the caller asks for the CPU)."""
    dev = device_lib.resolve(device)
    rng = np.random.default_rng(seed)
    centers = np.stack([
        rng.uniform(-4.0, 4.0, n_spheres),
        rng.uniform(0.4, 2.5, n_spheres),
        rng.uniform(4.0, 12.0, n_spheres),
    ], axis=-1).astype(np.float32)
    radii = rng.uniform(0.4, 1.4, n_spheres).astype(np.float32)
    centers[:, 1] = np.maximum(centers[:, 1], radii * 0.6)

    emission = np.zeros((n_spheres, 3), np.float32)
    # one bright emitter most of the time: the firefly source
    if rng.random() < 0.8:
        i = int(rng.integers(n_spheres))
        emission[i] = rng.uniform(30.0, 120.0, size=3)

    light_dir = rng.normal(size=3).astype(np.float32)
    light_dir[1] = abs(light_dir[1]) + 1.2
    light_dir /= np.linalg.norm(light_dir)
    light_center = (light_dir * rng.uniform(14.0, 22.0)).astype(np.float32)
    light_center[1] = max(light_center[1], 8.0)
    ln = -light_center / np.linalg.norm(light_center)

    g = len(groups)
    share = np.array([1.0, 0.45, 0.2, 0.12][:g], np.float32)[:, None]
    fields = dict(
        centers=centers,
        radii=radii,
        sphere_albedo=rng.uniform(0.05, 0.95, size=(n_spheres, 3)).astype(np.float32),
        emission=emission,
        plane_albedo=rng.uniform(0.1, 0.9, size=(2, 3)).astype(np.float32),
        checker_scale=np.float32(rng.uniform(0.6, 1.4)),
        light_center=light_center,
        light_radius=np.float32(rng.uniform(1.0, 3.5)),
        light_normal=ln.astype(np.float32),
        light_radiance=(rng.uniform(4.0, 12.0, size=3) * rng.uniform(2.0, 5.0)).astype(np.float32),
        sky_top=rng.uniform(0.1, 0.5, size=3).astype(np.float32),
        sky_hor=rng.uniform(0.3, 0.8, size=3).astype(np.float32),
        group_tint_d=(share * rng.uniform(0.6, 1.4, size=(g, 3))).astype(np.float32),
        group_tint_i=(share * rng.uniform(0.4, 1.1, size=(g, 3))).astype(np.float32),
        group_albedo_mix=np.concatenate([[1.0], rng.uniform(0.2, 0.9, size=g - 1)]
                                        ).astype(np.float32),
    )
    return Scene(**{k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                    for k, v in fields.items()})


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """Σ a*b over the last axis of 3, summed x, y, z in turn (the JAX
    package's reductions round the same way, a torch sum may not)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(x: Tensor) -> Tensor:
    """|x| over the last axis of 3, kept as an axis of 1."""
    return torch.sqrt(dot3(x, x))[..., None]


def make_scene_random(draws: Draws, batch: int, n_spheres: int = 7,
                      groups: Sequence[str] = LIGHT_GROUPS) -> Scene:
    """`batch` scenes drawn from `draws`, on its device: the twin of the JAX
    package's make_scene_jax (same ranges, same draws in the same order),
    so training batches draw their scenes on the card."""
    b, n, g = batch, n_spheres, len(groups)
    u = draws.uniform
    centers = torch.stack([u((b, n), -4.0, 4.0), u((b, n), 0.4, 2.5),
                           u((b, n), 4.0, 12.0)], dim=-1)
    radii = u((b, n), 0.4, 1.4)
    centers = torch.cat([centers[..., :1], torch.maximum(centers[..., 1:2], radii[..., None] * 0.6),
                         centers[..., 2:]], dim=-1)

    # the firefly source: one bright emitter 80% of the time
    emit_on = (u((b, 1, 1)) < 0.8).float()
    emit_idx = draws.randint((b,), 0, n)
    onehot = (torch.arange(n, device=draws.device) == emit_idx[:, None]).float()
    emission = onehot[..., None] * u((b, 1, 3), 30.0, 120.0) * emit_on

    light_dir = draws.normal((b, 3))
    light_dir = torch.cat([light_dir[:, :1], light_dir[:, 1:2].abs() + 1.2, light_dir[:, 2:]], -1)
    light_dir = light_dir / norm3(light_dir)
    light_center = light_dir * u((b, 1), 14.0, 22.0)
    light_center = torch.cat([light_center[:, :1], torch.clamp_min(light_center[:, 1:2], 8.0),
                              light_center[:, 2:]], -1)
    ln = -light_center / norm3(light_center)

    share = [1.0, 0.45, 0.2, 0.12][:g]
    sphere_albedo = u((b, n, 3), 0.05, 0.95)
    plane_albedo = u((b, 2, 3), 0.1, 0.9)
    checker_scale = u((b,), 0.6, 1.4)
    light_radius = u((b,), 1.0, 3.5)
    light_radiance = u((b, 3), 4.0, 12.0) * u((b, 1), 2.0, 5.0)
    sky_top = u((b, 3), 0.1, 0.5)
    sky_hor = u((b, 3), 0.3, 0.8)
    tint_d = torch.stack([s * t for s, t in zip(share, u((b, g, 3), 0.6, 1.4).unbind(1))], 1)
    tint_i = torch.stack([s * t for s, t in zip(share, u((b, g, 3), 0.4, 1.1).unbind(1))], 1)
    mix = torch.cat([torch.ones((b, 1), device=draws.device), u((b, g - 1), 0.2, 0.9)], -1)
    return Scene(centers, radii, sphere_albedo, emission, plane_albedo, checker_scale,
                 light_center, light_radius, ln, light_radiance, sky_top, sky_hor,
                 tint_d, tint_i, mix)


def scene_slice(scene: Scene, start: int, stop: int) -> Scene:
    """Scenes start..stop-1 of a batch of scenes."""
    return Scene(*(f[start:stop] for f in scene))


# --- geometry (rays and points (B, P, 3), the scene viewed by _view) -------


class _View(NamedTuple):
    """A batch of scenes shaped to broadcast against (B, P, ...) pixels:
    per-sphere fields (B, 1, N, ...), per-scene vectors (B, 1, 3) and
    scalars (B, 1); and the light disk's tangent frame, which every
    sample of the JAX tracer recomputes with the same arithmetic."""

    centers: Tensor
    radii: Tensor
    sphere_albedo: Tensor
    emission: Tensor
    plane_albedo: Tensor
    checker_scale: Tensor
    light_center: Tensor
    light_radius: Tensor
    light_normal: Tensor
    light_radiance: Tensor
    sky_top: Tensor
    sky_hor: Tensor
    disk_tx: Tensor
    disk_ty: Tensor


def _view(scene: Scene) -> _View:
    fields = [f[:, None] for f in scene[:12]]
    ln = fields[8]
    tx = _cross(_frame_up(ln), ln)
    tx = tx / norm3(tx)
    return _View(*fields, tx, _cross(ln, tx))


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _axis(like: Tensor, i: int, value: float = 1.0) -> Tensor:
    """`value` times the unit vector along axis i, shaped like `like`, made
    by fill kernels: a constant copied from the host would sync."""
    out = torch.zeros_like(like)
    out.select(-1, i).fill_(value)
    return out


def _true_div(x: Tensor, number: float) -> Tensor:
    """x / number, rounded as IEEE division on the card too: CUDA divides by
    a Python number as a product with its reciprocal, an ulp off the CPU's
    (and XLA's) quotient, which moves silhouette and checker decisions."""
    return x / torch.full((), float(number), device=x.device)


def _frame_up(normal: Tensor) -> Tensor:
    """+y, or +x where the normal is within ~25° of the y axis."""
    return torch.where(normal[..., 1:2].abs() < 0.9, _axis(normal, 1), _axis(normal, 0))


def _sphere_terms(v: _View, origin: Tensor, dirs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(b, disc, sq) of every ray against every sphere, (B, P, N)."""
    oc = origin[..., None, :] - v.centers
    b = dot3(dirs[..., None, :], oc)
    c = dot3(oc, oc) - v.radii * v.radii
    disc = b * b - c
    return b, disc, torch.sqrt(torch.clamp_min(disc, 0.0))


def _intersect(v: _View, origin: Tensor, dirs: Tensor) -> Tuple[Tensor, Tensor]:
    """Nearest hit along rays: (t, hit_id), t = inf on a miss, hit_id = the
    sphere's index, -1 for the ground plane, -2 for the sky. Ties go to the
    plane, then to the lowest sphere index (the JAX loop's strict <)."""
    dy = dirs[..., 1]
    oy = origin[..., 1]
    t_plane = torch.where(dy < -1e-6, -oy / torch.clamp_max(dy, -1e-6), math.inf)
    t_best = torch.where(t_plane > 1e-4, t_plane, math.inf)
    hit_id = torch.where(torch.isfinite(t_best), -1, -2)
    b, disc, sq = _sphere_terms(v, origin, dirs)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    t = torch.where((disc > 0) & (t > 1e-3), t, math.inf)
    t_sph, idx = t.min(dim=-1)
    closer = t_sph < t_best
    return torch.where(closer, t_sph, t_best), torch.where(closer, idx, hit_id)


def _occluded(v: _View, origin: Tensor, dirs: Tensor, max_t: Tensor) -> Tensor:
    """(B, P) bool: a sphere blocks the segment [0, max_t) along dirs (the
    ground plane never occludes the light, which sits high)."""
    b, disc, sq = _sphere_terms(v, origin, dirs)
    t0 = -b - sq
    return ((disc > 0) & (t0 > 1e-3) & (t0 < max_t[..., None])).any(dim=-1)


def _sky(v: _View, dirs: Tensor) -> Tensor:
    t = torch.clamp(dirs[..., 1:2] * 1.5 + 0.2, 0.0, 1.0)
    return t * v.sky_top + (1.0 - t) * v.sky_hor


def _per_sphere(table: Tensor, hit_id: Tensor) -> Tensor:
    """table (B, 1, N, C) at each pixel's sphere (index 0 where hit_id < 0)."""
    t = table[:, 0]
    idx = hit_id.clamp_min(0)[..., None].expand(-1, -1, t.shape[-1])
    return torch.gather(t, 1, idx)


def _surface_albedo(v: _View, points: Tensor, hit_id: Tensor) -> Tensor:
    """Diffuse-group albedo at surface points: the checker on the plane, the
    sphere's albedo on a sphere, 0 on the sky. The checker's % is Python's
    (the sign of the divisor), which torch.remainder computes."""
    s = v.checker_scale
    check = torch.remainder(torch.floor(points[..., 0] * s) + torch.floor(points[..., 2] * s),
                            2)[..., None]
    albedo = v.plane_albedo[..., 0, :] * check + v.plane_albedo[..., 1, :] * (1 - check)
    albedo = torch.where((hit_id >= 0)[..., None], _per_sphere(v.sphere_albedo, hit_id), albedo)
    return torch.where((hit_id >= -1)[..., None], albedo, 0.0)


def _surface_normal(v: _View, points: Tensor, hit_id: Tensor) -> Tensor:
    centers = _per_sphere(v.centers, hit_id)
    radii = _per_sphere(v.radii[..., None], hit_id)
    return torch.where((hit_id >= 0)[..., None], (points - centers) / radii, _axis(points, 1))


def _emitted(v: _View, hit_id: Tensor) -> Tensor:
    return torch.where((hit_id >= 0)[..., None], _per_sphere(v.emission, hit_id), 0.0)


def _sample_disk(v: _View, draws: Draws, shape) -> Tensor:
    """Uniform points on the area light's disk, (B, P, 3)."""
    r = v.light_radius * torch.sqrt(draws.uniform(shape))
    phi = 2.0 * math.pi * draws.uniform(shape)
    return (v.light_center + (r * torch.cos(phi))[..., None] * v.disk_tx
            + (r * torch.sin(phi))[..., None] * v.disk_ty)


def _cosine_dir(normal: Tensor, draws: Draws, shape) -> Tensor:
    """Cosine-weighted hemisphere directions about per-pixel normals. u1 is
    drawn on [1e-7, 1), as JAX's uniform(minval=1e-7)."""
    u1 = draws.uniform(shape, 1e-7, 1.0)
    u2 = draws.uniform(shape)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    tx = _cross(_frame_up(normal), normal)
    tx = tx / torch.clamp_min(norm3(tx), 1e-6)
    ty = _cross(normal, tx)
    return x[..., None] * tx + y[..., None] * ty + z[..., None] * normal


def _direct_sample(v: _View, pts: Tensor, normal: Tensor, draws: Draws) -> Tensor:
    """One area-light sample of the direct (demodulated) radiance at pts:
    L_e * V * cos_surf * cos_light * A / (pi * d^2), pdf 1/A on the disk."""
    q = _sample_disk(v, draws, pts.shape[:-1])
    to_l = q - pts
    d2 = torch.clamp_min(dot3(to_l, to_l), 1e-6)
    dist = torch.sqrt(d2)
    wi = to_l / dist[..., None]
    cos_s = torch.clamp_min(dot3(normal, wi), 0.0)
    cos_l = torch.clamp_min(dot3(-wi, v.light_normal), 0.0)
    vis = ~_occluded(v, pts + normal * 1e-3, wi, dist - 1e-2)
    area = math.pi * (v.light_radius * v.light_radius)
    geom = vis * cos_s * cos_l * area / (math.pi * d2)
    return geom[..., None] * v.light_radiance


def _indirect_sample(v: _View, pts: Tensor, normal: Tensor, draws: Draws) -> Tensor:
    """One cosine-hemisphere sample of the incoming (demodulated) radiance:
    the sky on a miss, emission + albedo * one-bounce direct on a hit."""
    d = _cosine_dir(normal, draws, pts.shape[:-1])
    org = pts + normal * 1e-3
    t, hid = _intersect(v, org, d)
    t_safe = torch.where(torch.isfinite(t), t, 1.0)
    hpts = org + d * t_safe[..., None]
    hnorm = _surface_normal(v, hpts, hid)
    halb = _surface_albedo(v, hpts, hid)
    bounce_direct = _direct_sample(v, hpts, hnorm, draws)
    hit_rad = _emitted(v, hid) + halb * bounce_direct
    return torch.where((hid >= -1)[..., None], hit_rad, _sky(v, d))


def _pixel_rows(origin, n: int, batch: int, device) -> Tensor:
    """(B, n) float pixel indices origin + 0..n-1 for an int or (B,) origin."""
    ar = torch.arange(n, dtype=torch.float32, device=device)
    if isinstance(origin, Tensor):
        return origin.to(device=device, dtype=torch.float32)[:, None] + ar
    return (origin + ar).expand(batch, n)


def render(scene: Scene, height: int, width: int, spp: int, draws: Draws,
           groups: Sequence[str] = LIGHT_GROUPS, window_origin=None,
           full_shape: Optional[Tuple[int, int]] = None) -> Dict[str, Tensor]:
    """Trace a frame at `spp` samples per pixel; returns the full pass dict
    on the scene's device: (height, width, C) tensors for one scene,
    (B, height, width, C) for a batch of B scenes.

    `window_origin=(oy, ox)` with `full_shape=(fh, fw)` renders a
    height x width crop of a virtual fh x fw frame; oy and ox are ints, or
    (B,) integer tensors for a batch (one window per scene). The default
    is the whole frame."""
    single = scene.radii.dim() == 1
    if single:
        scene = Scene(*(f[None] for f in scene))
    dev = scene.radii.device
    bsz = scene.radii.shape[0]
    v = _view(scene)

    # --- primary rays: deterministic (pixel centres) ----------------------
    fh, fw = (height, width) if full_shape is None else full_shape
    aspect = fw / fh
    fov = 0.9
    oy, ox = (0, 0) if window_origin is None else window_origin
    yy = (1.0 - _true_div(2.0 * _pixel_rows(oy, height, bsz, dev), fh - 1))[:, :, None]
    xx = (-aspect + _true_div(2.0 * aspect * _pixel_rows(ox, width, bsz, dev), fw - 1))[:, None, :]
    shape = (bsz, height, width)
    dirs = torch.stack([(xx * fov).expand(shape), (yy * fov).expand(shape),
                        torch.ones(shape, device=dev)], dim=-1)
    dirs = (dirs / norm3(dirs)).reshape(bsz, height * width, 3)
    origin = _axis(torch.zeros(3, device=dev), 1, 1.5)

    t, hit_id = _intersect(v, origin, dirs)
    hit = hit_id >= -1
    t_safe = torch.where(torch.isfinite(t), t, 50.0)
    pts = origin + dirs * t_safe[..., None]
    normal = _surface_normal(v, pts, hit_id)

    # --- deterministic buffers (noise-free, as in Cycles) -----------------
    out: Dict[str, Tensor] = {}
    view_n = torch.stack([normal[..., 0], normal[..., 1], -normal[..., 2]], dim=-1)
    view_n = torch.where(hit[..., None], view_n, _axis(view_n, 2))
    out["normal"] = view_n / torch.clamp_min(norm3(view_n), 1e-6)
    out["depth"] = torch.where(hit, t_safe, 50.0)[..., None]
    out["alpha"] = hit[..., None].float()
    out["emission"] = _emitted(v, hit_id) * hit[..., None]
    out["environment"] = _sky(v, dirs) * (~hit)[..., None]

    base_albedo = _surface_albedo(v, pts, hit_id)

    # --- the Monte-Carlo estimate: mean of spp i.i.d. samples -------------
    d_sum = torch.zeros_like(pts)
    i_sum = torch.zeros_like(pts)
    for _ in range(spp):
        d_sum += _direct_sample(v, pts, normal, draws)
        i_sum += _indirect_sample(v, pts, normal, draws)
    d_est = _true_div(d_sum, spp) * hit[..., None]
    i_est = _true_div(i_sum, spp) * hit[..., None]

    grey = torch.full_like(base_albedo, 0.7)
    for gi, g in enumerate(groups):
        d_name, i_name, c_name = passes.group_passes(g)
        mix = scene.group_albedo_mix[:, gi, None, None]
        out[c_name] = (mix * base_albedo + (1.0 - mix) * grey) * hit[..., None]
        out[d_name] = d_est * scene.group_tint_d[:, None, gi]
        out[i_name] = i_est * scene.group_tint_i[:, None, gi]
    # the recomposition identity holds by construction
    out["combined"] = transforms.recompose(out, groups=tuple(groups))
    out = {k: x.reshape(bsz, height, width, x.shape[-1]) for k, x in out.items()}
    return {k: x[0] for k, x in out.items()} if single else out


# --- the family API (frames as tensors on the device) ----------------------


def generate_clean_passes(height: int, width: int, seed: int = 0, spp: int = DEFAULT_GT_SPP,
                          groups: Sequence[str] = LIGHT_GROUPS,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, Tensor]:
    """The ground truth: the estimator at a high sample count (residual
    noise power spp_gt/spp_noisy under the noisy realization's). Draws
    seeded by seed*7919+1, as the JAX package keys it; returns tensors on
    `device` (the JAX package returns numpy)."""
    dev = device_lib.resolve(device)
    scene = make_scene(seed, groups=groups, device=dev)
    return render(scene, height, width, spp, seeded(seed * 7919 + 1, dev), tuple(groups))


def generate_noisy_passes(height: int, width: int, seed: int = 0, spp: int = 4,
                          sample_seed: int = 0, groups: Sequence[str] = LIGHT_GROUPS,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, Tensor]:
    """A genuine spp-sample realization of the same scene; its draws are
    seeded by (seed*7919+2, sample_seed), disjoint from the GT's."""
    dev = device_lib.resolve(device)
    scene = make_scene(seed, groups=groups, device=dev)
    return render(scene, height, width, spp, seeded((seed * 7919 + 2, sample_seed), dev),
                  tuple(groups))


def generate_frame_set(height: int, width: int, seed: int, spps: Sequence[int] = (4, 16),
                       n_seeds: int = 2, gt_spp: int = DEFAULT_GT_SPP,
                       groups: Sequence[str] = LIGHT_GROUPS,
                       device: Optional[Union[str, torch.device]] = None):
    """(clean, [noisy...]) with the other families' frame-set contract; every
    noisy frame is a true N-sample estimate."""
    clean = generate_clean_passes(height, width, seed, spp=gt_spp, groups=groups, device=device)
    noisy = [
        generate_noisy_passes(height, width, seed, spp=spp, sample_seed=97 * k + spp,
                              groups=groups, device=device)
        for spp in spps
        for k in range(n_seeds)
    ]
    return clean, noisy
