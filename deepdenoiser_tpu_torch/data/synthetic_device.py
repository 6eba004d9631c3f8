"""Synthetic training batches made on the device, with no host in the loop.

The port of deepdenoiser_tpu/data/synthetic_jax.py, the recipe that
trained the release weights. Every tensor stays on the draw source's
device and nothing syncs with the host, so a batch costs launches, not a
host->device feed. Four generators, each making a batch of n examples
(every example a fresh scene) as (n, h, w, C) pass dicts:

  * Fourier (generate_clean_passes): band-limited random sinusoid fields,
    smooth and globally correlated;
  * Voronoi (generate_voronoi_passes): piecewise-constant albedo cells
    with hard edges, per-cell planar depth, a directional light with a
    penumbra shadow and a blurred bounce;
  * traced Monte Carlo (data/mc_tracer.py): a crop window of a virtual
    1080p frame, noisy = a genuine 4- or 16-sample estimate, GT = the
    same estimator at MC_TRAIN_GT_SPP;

and the Gaussian MC noise model (add_mc_noise) for the first two.
`randomize_scene` adds scene-scale (depth) and exposure (radiance)
randomization. `training_batch` encodes (noisy, clean) pairs as the host
loader does, for the five families fourier, voronoi, mc, mixed and
mixed-mc.

Random numbers come from a draw source (data/draws.py) in the order the
JAX functions draw them for one example, so a source that replays the
JAX draws gives the JAX numbers. Where the JAX package rides the matrix
unit (the Voronoi cells' one-hot matmul) the port gathers, which is exact
under TF32; the box blur is a sum of shifted copies in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.data import mc_tracer
from deepdenoiser_tpu_torch.data.draws import Draws
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS

Tensor = torch.Tensor
Passes = Dict[str, Tensor]


def _linspace(lo: float, hi: float, num: int, device) -> Tensor:
    """jnp.linspace's float32 arithmetic: lo*(1-s) + hi*s with s = i times
    the float32 reciprocal of num-1 (XLA's rewrite of i/(num-1)), and hi
    itself last; torch.linspace rounds otherwise. The sinusoid fields
    multiply these by up to 2*pi*16, so an ulp here is 100 ulps there."""
    if num == 1:
        return torch.full((1,), lo, device=device)
    recip = float(np.float32(1.0) / np.float32(num - 1))
    s = torch.arange(num - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([lo * (1 - s) + hi * s, torch.full((1,), hi, device=device)])


def _smooth_field(draws: Draws, n: int, h: int, w: int, c: int, octaves: int = 4,
                  base_freq: float = 2.0, t: float = 0.0) -> Tensor:
    """(n, h, w, c) band-limited sinusoid fields in [0, 1]. `t` drifts each
    octave's phase at a drawn velocity: the same draws at another t give a
    temporally coherent animation."""
    dev = draws.device
    yy = _linspace(0.0, 1.0, h, dev)[:, None, None]
    xx = _linspace(0.0, 1.0, w, dev)[None, :, None]
    out = torch.zeros((n, h, w, c), device=dev)
    total = 0.0
    amp = 1.0
    for o in range(octaves):
        freq = base_freq * (2.0 ** o)
        fy = draws.uniform((n, 1, 1, c), -freq, freq)
        fx = draws.uniform((n, 1, 1, c), -freq, freq)
        ph = draws.uniform((n, 1, 1, c), 0.0, 2 * math.pi)
        vel = draws.uniform((n, 1, 1, c), -1.0, 1.0)
        ph = ph + vel * t
        out = out + amp * torch.sin(2 * math.pi * (fy * yy + fx * xx) + ph)
        total += amp
        amp *= 0.55
    return 0.5 * (out / total + 1.0)


def _recompose(d: Passes, groups: Sequence[str]) -> Tensor:
    acc = None
    for g in groups:
        dn, inn, cn = passes.group_passes(g)
        t = d[cn] * (d[dn] + d[inn])
        acc = t if acc is None else acc + t
    for extra in passes.COMPOSITE_EXTRA:
        if extra in d:
            acc = acc + d[extra]
    return acc


def generate_clean_passes(draws: Draws, n: int, h: int, w: int,
                          groups: Sequence[str] = LIGHT_GROUPS, hdr_scale: float = 4.0,
                          t: float = 0.0) -> Passes:
    """n Fourier-family pass sets, (n, h, w, C) each, recomposition-consistent."""
    out: Passes = {}
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        color = _smooth_field(draws, n, h, w, 3, t=t)
        mask = _smooth_field(draws, n, h, w, 1, t=t) > 0.85
        out[c_name] = torch.where(mask, color * 0.01, color)
        out[d_name] = hdr_scale * _smooth_field(draws, n, h, w, 3, t=t) ** 2.0
        out[i_name] = 0.4 * hdr_scale * _smooth_field(draws, n, h, w, 3, t=t) ** 2.0
    out["emission"] = 0.2 * _smooth_field(draws, n, h, w, 3, t=t) ** 4.0
    out["environment"] = 0.1 * _smooth_field(draws, n, h, w, 3, t=t)
    nrm = _smooth_field(draws, n, h, w, 3, t=t) * 2.0 - 1.0
    out["normal"] = nrm / torch.clamp_min(mc_tracer.norm3(nrm), 1e-6)
    out["depth"] = 20.0 * _smooth_field(draws, n, h, w, 1, t=t) ** 1.5
    out["alpha"] = torch.clamp(_smooth_field(draws, n, h, w, 1, t=t) * 1.6, 0.0, 1.0)
    out["combined"] = _recompose(out, groups)
    return out


def _edge_pad(x: Tensor, r: int, dim: int) -> Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1)
    reps = [1] * x.dim()
    reps[dim] = r
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=dim)


def _box_blur(x: Tensor, r: int) -> Tensor:
    """Separable box blur with edge clamping, (n, h, w, c) -> (n, h, w, c):
    the mean over the 2r+1 window along h, then along w, each a sum of
    shifted copies times 1/(2r+1) in fp32 (the JAX package's depthwise
    convolutions, with no TF32 rounding on the card)."""
    if r <= 0:
        return x
    k = 2 * r + 1
    wgt = 1.0 / k
    out = x
    for dim in (1, 2):
        size = out.shape[dim]
        p = _edge_pad(out, r, dim)
        acc = p.narrow(dim, 0, size) * wgt
        for j in range(1, k):
            acc = acc + p.narrow(dim, j, size) * wgt
        out = acc
    return out


def _cells(labels: Tensor, attr: Tensor) -> Tensor:
    """Per-cell attributes (n, K, m) at each pixel's cell label (n, h, w)."""
    n, h, w = labels.shape
    m = attr.shape[-1]
    idx = labels.reshape(n, h * w, 1).expand(n, h * w, m)
    return torch.gather(attr, 1, idx).reshape(n, h, w, m)


def generate_voronoi_passes(draws: Draws, n: int, h: int, w: int,
                            groups: Sequence[str] = LIGHT_GROUPS, n_cells: int = 16,
                            light_scale: float = 4.0) -> Passes:
    """n Voronoi-cell pass sets, recomposition-consistent (the JAX package's
    generate_voronoi_passes; structure documented in
    data/synthetic_holdout.py)."""
    dev = draws.device
    k = n_cells
    u = draws.uniform
    out: Passes = {}
    sites = u((n, k, 2))
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    dy = yy - (sites[..., 0] * float(h))[:, None, None, :]
    dx = xx - (sites[..., 1] * float(w))[:, None, None, :]
    labels = torch.argmin(dy * dy + dx * dx, dim=-1)  # (n, h, w)

    def cell(attr: Tensor) -> Tensor:
        return _cells(labels, attr)

    # --- geometry: per-cell base normals + blurred-noise bump texture ----
    base_n = draws.normal((n, k, 3))
    base_n = torch.cat([base_n[..., :2], base_n[..., 2:].abs() + 1.5], dim=-1)
    base_n = base_n / mc_tracer.norm3(base_n)
    bump = _box_blur(draws.normal((n, h, w, 3)), 1)
    nrm = cell(base_n) + 0.15 * bump
    nrm = nrm / torch.clamp_min(mc_tracer.norm3(nrm), 1e-6)
    out["normal"] = nrm

    # per-cell planar depth: discontinuities at cell borders
    yyn = _linspace(-0.5, 0.5, h, dev)[:, None]
    xxn = _linspace(-0.5, 0.5, w, dev)[None, :]
    d0 = u((n, k), 2.0, 30.0)
    gy = u((n, k), -8.0, 8.0)
    gx = u((n, k), -8.0, 8.0)
    plane = cell(torch.stack([d0, gy, gx], dim=-1))
    depth = plane[..., 0] + plane[..., 1] * yyn + plane[..., 2] * xxn
    out["depth"] = torch.clamp_min(depth, 0.05)[..., None]

    see_through = (u((n, k, 1)) < 0.12).float()
    alpha = 1.0 - 0.6 * cell(see_through)
    out["alpha"] = torch.clamp(_box_blur(alpha, 2), 0.0, 1.0)

    # --- illumination: directional lambert + penumbra shadow + bounce ----
    light = draws.normal((n, 1, 1, 3))
    light = torch.cat([light[..., :2], light[..., 2:].abs() + 1.0], dim=-1)
    light = light / mc_tracer.norm3(light)
    lambert = torch.clamp_min(mc_tracer.dot3(nrm, light), 0.0)[..., None]
    sy_sx = draws.normal((n, 1, 1, 2))
    c = u((n, 1, 1), -0.2, 0.2)
    occluded = ((sy_sx[..., 0] * yyn + sy_sx[..., 1] * xxn + c) > 0).float()
    penumbra = max(3, min(h, w) // 24)
    vis = 1.0 - 0.85 * _box_blur(occluded[..., None], penumbra)
    bounce = _box_blur(lambert, max(4, min(h, w) // 12))

    # --- per-group albedo + radiance -------------------------------------
    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        cell_col = u((n, k, 3), 0.05, 0.95)
        dark = u((n, k, 1)) < 0.1
        out[c_name] = cell(torch.where(dark, cell_col * 0.01, cell_col))
        tint_d = u((n, 1, 1, 3), 0.5, 1.5)
        tint_i = u((n, 1, 1, 3), 0.2, 0.8)
        intensity = light_scale * u((n, 1, 1, 1), 0.3, 1.0)
        out[d_name] = intensity * lambert * vis * tint_d
        out[i_name] = 0.5 * intensity * bounce * tint_i

    # --- emission / environment ------------------------------------------
    emissive = u((n, k, 1)) < 0.08
    em_col = u((n, k, 3), 0.5, 3.0)
    out["emission"] = cell(torch.where(emissive, em_col, 0.0))
    sky_top = u((n, 1, 1, 3), 0.02, 0.3)
    sky_bot = u((n, 1, 1, 3), 0.0, 0.1)
    t = _linspace(0.0, 1.0, h, dev)[:, None, None]
    out["environment"] = ((1 - t) * sky_top + t * sky_bot).expand(n, h, w, 3)
    out["combined"] = _recompose(out, groups)
    return out


def _scene_factors(draws: Draws, n: int) -> Tuple[Tensor, Tensor]:
    """(exposure, depth scale), each 2^U(-2, 2), (n, 1, 1, 1)."""
    exposure = 2.0 ** draws.uniform((n, 1, 1, 1), -2.0, 2.0)
    zscale = 2.0 ** draws.uniform((n, 1, 1, 1), -2.0, 2.0)
    return exposure, zscale


def _apply_factors(clean: Passes, exposure: Tensor, zscale: Tensor) -> Passes:
    out = {}
    for name, x in clean.items():
        p = passes.get(name)
        if p.kind is passes.PassKind.RADIANCE:
            out[name] = x * exposure
        elif p.kind is passes.PassKind.DEPTH:
            out[name] = x * zscale
        else:
            out[name] = x
    return out


def randomize_scene(draws: Draws, clean: Passes) -> Passes:
    """Scene-scale and exposure randomization: the radiance passes
    (direct/indirect/emission/environment/combined) share one exposure
    factor 2^U(-2,2) per example, depth gets its own 2^U(-2,2).
    Recomposition is linear in radiance at fixed colour, so the identity
    holds exactly."""
    n = next(iter(clean.values())).shape[0]
    return _apply_factors(clean, *_scene_factors(draws, n))


def add_mc_noise(draws: Draws, clean: Passes, spp, groups: Sequence[str] = LIGHT_GROUPS,
                 base_sigma: float = 1.0) -> Passes:
    """One noisy realization per example: direct/indirect radiance gets
    zero-mean signal-proportional Gaussian noise with std ∝ 1/sqrt(spp),
    clipped at 0; albedo a whisper, clipped to [0, 1]; the other passes
    stay clean (emission and environment are near-deterministic in Cycles).
    `spp`: a number, or an (n, 1, 1, 1) tensor (one per example). Passes
    are visited in sorted name order, as the JAX function splits keys."""
    dev = next(iter(clean.values())).device
    if not isinstance(spp, torch.Tensor):  # made on the device: a host constant would sync
        spp = torch.full((), float(spp), device=dev)
    sigma = base_sigma / torch.sqrt(spp)
    noisy: Passes = {}
    for name in sorted(clean):
        x = clean[name]
        p = passes.get(name)
        if p.role in (passes.Role.DIRECT, passes.Role.INDIRECT):
            noise = draws.normal(x.shape)
            noisy[name] = torch.clamp_min(x + sigma * (x + 0.05) * noise, 0.0)
        elif p.kind is passes.PassKind.COLOR:
            noise = draws.normal(x.shape)
            noisy[name] = torch.clamp(x + 0.02 * sigma * noise, 0.0, 1.0)
        else:
            noisy[name] = x
    noisy["combined"] = _recompose(noisy, groups)
    return noisy


# GT sample count of traced training targets: 256 spp sits 18 dB under a
# 4-spp input (noise power ~ 1/spp); the residual is zero-mean per pixel,
# so the regression's minimizer is unchanged. Read at call time (tests
# patch it).
MC_TRAIN_GT_SPP = 256
_MC_FULL_SHAPE = (1080, 1920)  # the virtual full frame the windows crop from


def _encode_pair(noisy: Passes, clean: Passes, mode: str) -> Passes:
    """(noisy, clean) -> {'x', 'y'} with the host loader's encode semantics
    (data/loader.make_batch_encoder): targets are demodulated by the NOISY
    albedo the network sees."""
    if mode == "joint":
        x = transforms.encode_joint_inputs(noisy)
        ys = []
        for g in LIGHT_GROUPS:
            dn, inn, cn = passes.group_passes(g)
            albedo = noisy[cn]
            ys.append(transforms.normalize(dn, transforms.demodulate(clean[dn], albedo)))
            ys.append(transforms.normalize(inn, transforms.demodulate(clean[inn], albedo)))
        y = torch.cat(ys, dim=-1)
    elif mode == "group":
        x = transforms.encode_group_inputs(noisy, "diffuse")
        dn, inn, cn = passes.group_passes("diffuse")
        albedo = noisy[cn]
        y = torch.cat([
            transforms.normalize(dn, transforms.demodulate(clean[dn], albedo)),
            transforms.normalize(inn, transforms.demodulate(clean[inn], albedo)),
        ], dim=-1)
    else:  # rgb
        x = transforms.encode_rgb_inputs(noisy)
        y = transforms.normalize("combined", clean["combined"])
    return {"x": x, "y": y}


def _mc_subbatch(draws: Draws, n: int, crop: int, mode: str) -> Passes:
    """n traced-MC examples: random crop windows of a virtual 1080p frame,
    one scene each; noisy = a genuine 4-sample estimate for the first
    max(n - n//2, 1), 16 for the rest; GT = MC_TRAIN_GT_SPP samples, all n
    in one render. Exposure and scene scale apply the same factors to both."""
    scene = mc_tracer.make_scene_random(draws, n)
    fh, fw = _MC_FULL_SHAPE
    oy = draws.randint((n,), 0, fh - crop + 1)
    ox = draws.randint((n,), 0, fw - crop + 1)
    clean = mc_tracer.render(scene, crop, crop, MC_TRAIN_GT_SPP, draws, LIGHT_GROUPS,
                             (oy, ox), (fh, fw))
    n4 = max(n - n // 2, 1)
    parts = [mc_tracer.render(mc_tracer.scene_slice(scene, a, b), crop, crop, spp, draws,
                              LIGHT_GROUPS, (oy[a:b], ox[a:b]), (fh, fw))
             for a, b, spp in ((0, n4, 4), (n4, n, 16)) if b > a]
    noisy = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    exposure, zscale = _scene_factors(draws, n)
    return _encode_pair(_apply_factors(noisy, exposure, zscale),
                        _apply_factors(clean, exposure, zscale), mode)


def _concat(*batches: Passes) -> Passes:
    return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}


FAMILIES = ("fourier", "voronoi", "mc", "mixed", "mixed-mc")


def training_batch(generator: torch.Generator, batch: int, crop: int, mode: str = "joint",
                   family: str = "fourier") -> Passes:
    """{'x', 'y'}: an encoded training batch of `batch` crops of crop x crop,
    made on the generator's device (torch.Generator(device="cuda") for the
    card) with no host sync.

    One fresh scene per example; one noisy realization at spp 2^U(1,6).
    `family`: 'fourier' (no scene randomization); 'voronoi'; 'mc' (traced
    Monte Carlo: the spp-4 half first, then spp 16); 'mixed' (Fourier then
    Voronoi, halves, both randomized); 'mixed-mc' (thirds: Fourier,
    Voronoi, mc). Holdout hygiene: the mc scenes share the sphere geometry
    class with the spheres holdout, so with an mc family the boxes holdout
    (data/synthetic_boxes.py) is the untouched arbiter."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    draws = Draws(generator)

    def one(n: int, gen, rand: bool) -> Passes:
        clean = gen(draws, n, crop, crop)
        if rand:
            clean = randomize_scene(draws, clean)
        spp = 2.0 ** draws.uniform((n, 1, 1, 1), 1.0, 6.0)
        return _encode_pair(add_mc_noise(draws, clean, spp), clean, mode)

    if family == "fourier":
        return one(batch, generate_clean_passes, False)
    if family == "voronoi":
        return one(batch, generate_voronoi_passes, True)
    if family == "mc":
        return _mc_subbatch(draws, batch, crop, mode)
    if family == "mixed":
        n_v = batch // 2
        if n_v == 0:
            return one(batch, generate_clean_passes, True)
        return _concat(one(batch - n_v, generate_clean_passes, True),
                       one(n_v, generate_voronoi_passes, True))
    n_f = max(batch // 3, 1)
    n_v = max(batch // 3, 1)
    n_m = batch - n_f - n_v
    if n_m < 1:
        raise ValueError(f"mixed-mc needs batch >= 3, got {batch}")
    return _concat(one(n_f, generate_clean_passes, True),
                   one(n_v, generate_voronoi_passes, True),
                   _mc_subbatch(draws, n_m, crop, mode))
