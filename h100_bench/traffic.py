"""The benchmark's traffic: multi-pass frames and encoded training batches,
made on the device from the run's seed.

Frozen copy of deepdenoiser_tpu_torch/data/synthetic_device.py at commit
903e8b8 (the Fourier family `generate_clean_passes`, `add_mc_noise`, the
joint and group `_encode_pair`, `training_batch` for the Fourier family),
with the pass registry and the encode it needs, made to stand alone so a
change to the program cannot change the yardstick. One torch.Generator on
the device, seeded by --seed, draws everything in a few large calls; the
same seed gives the same inputs.

A traffic file (traffic/<name>.json) names its driver and the parameters
that this generator reads:
  frames: height, width, pool (frames made), spp (MC noise samples)
  train:  batch, crop, pool (batches made), family ("fourier")
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
Passes = Dict[str, Tensor]

LIGHT_GROUPS = ("diffuse", "glossy", "subsurface", "transmission")
AUX_PASSES = ("normal", "depth", "alpha")
COMPOSITE_EXTRA = ("emission", "environment")
DEMOD_EPS = 1e-2


def group_passes(group: str):
    return f"{group}_direct", f"{group}_indirect", f"{group}_color"


def _kind(name: str) -> str:
    """Value kind of a pass: radiance, color, normal, depth or alpha."""
    if name.endswith("_color"):
        return "color"
    if name in ("normal", "depth", "alpha"):
        return name
    return "radiance"


def _is_direct_or_indirect(name: str) -> bool:
    return name.endswith("_direct") or name.endswith("_indirect")


def normalize(name: str, x: Tensor) -> Tensor:
    k = _kind(name)
    if k in ("radiance", "depth"):
        return torch.log1p(torch.clamp_min(x, 0.0))
    if k == "normal":
        return torch.clamp(x, -1.0, 1.0)
    if k == "alpha":
        return torch.clamp(x, 0.0, 1.0)
    return x


class Draws:
    def __init__(self, generator: torch.Generator):
        self.generator, self.device = generator, generator.device

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def normal(self, shape) -> Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)


def draws(seed: int, device) -> Draws:
    """A draw source on `device` seeded by the run's seed (any size: mixed
    into 64 bits by numpy's SeedSequence)."""
    mixed = int(np.random.SeedSequence([int(seed)]).generate_state(1, np.uint64)[0])
    return Draws(torch.Generator(device=device).manual_seed(mixed))


def _linspace(lo: float, hi: float, num: int, device) -> Tensor:
    if num == 1:
        return torch.full((1,), lo, device=device)
    recip = float(np.float32(1.0) / np.float32(num - 1))
    s = torch.arange(num - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([lo * (1 - s) + hi * s, torch.full((1,), hi, device=device)])


def _smooth_field(d: Draws, n: int, h: int, w: int, c: int, octaves: int = 4,
                  base_freq: float = 2.0) -> Tensor:
    """(n, h, w, c) band-limited sinusoid fields in [0, 1]."""
    dev = d.device
    yy = _linspace(0.0, 1.0, h, dev)[:, None, None]
    xx = _linspace(0.0, 1.0, w, dev)[None, :, None]
    out = torch.zeros((n, h, w, c), device=dev)
    total, amp = 0.0, 1.0
    for o in range(octaves):
        freq = base_freq * (2.0 ** o)
        fy = d.uniform((n, 1, 1, c), -freq, freq)
        fx = d.uniform((n, 1, 1, c), -freq, freq)
        ph = d.uniform((n, 1, 1, c), 0.0, 2 * math.pi)
        d.uniform((n, 1, 1, c), -1.0, 1.0)  # an animation's phase velocity: kept in the stream
        out = out + amp * torch.sin(2 * math.pi * (fy * yy + fx * xx) + ph)
        total += amp
        amp *= 0.55
    return 0.5 * (out / total + 1.0)


def _recompose(p: Passes, groups: Sequence[str]) -> Tensor:
    acc = None
    for g in groups:
        dn, inn, cn = group_passes(g)
        t = p[cn] * (p[dn] + p[inn])
        acc = t if acc is None else acc + t
    for extra in COMPOSITE_EXTRA:
        if extra in p:
            acc = acc + p[extra]
    return acc


def _norm3(x: Tensor) -> Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])[..., None]


def generate_clean_passes(d: Draws, n: int, h: int, w: int,
                          groups: Sequence[str] = LIGHT_GROUPS, hdr_scale: float = 4.0) -> Passes:
    """n Fourier-family pass sets, (n, h, w, C) each, recomposition-consistent."""
    out: Passes = {}
    for g in groups:
        d_name, i_name, c_name = group_passes(g)
        color = _smooth_field(d, n, h, w, 3)
        mask = _smooth_field(d, n, h, w, 1) > 0.85
        out[c_name] = torch.where(mask, color * 0.01, color)
        out[d_name] = hdr_scale * _smooth_field(d, n, h, w, 3) ** 2.0
        out[i_name] = 0.4 * hdr_scale * _smooth_field(d, n, h, w, 3) ** 2.0
    out["emission"] = 0.2 * _smooth_field(d, n, h, w, 3) ** 4.0
    out["environment"] = 0.1 * _smooth_field(d, n, h, w, 3)
    nrm = _smooth_field(d, n, h, w, 3) * 2.0 - 1.0
    out["normal"] = nrm / torch.clamp_min(_norm3(nrm), 1e-6)
    out["depth"] = 20.0 * _smooth_field(d, n, h, w, 1) ** 1.5
    out["alpha"] = torch.clamp(_smooth_field(d, n, h, w, 1) * 1.6, 0.0, 1.0)
    out["combined"] = _recompose(out, groups)
    return out


def add_mc_noise(d: Draws, clean: Passes, spp, groups: Sequence[str] = LIGHT_GROUPS,
                 base_sigma: float = 1.0) -> Passes:
    """Signal-proportional Gaussian noise on direct and indirect radiance
    (std ∝ 1/sqrt(spp)), a whisper on albedo; the rest stays clean; passes
    visited in sorted name order."""
    dev = next(iter(clean.values())).device
    if not isinstance(spp, torch.Tensor):
        spp = torch.full((), float(spp), device=dev)
    sigma = base_sigma / torch.sqrt(spp)
    noisy: Passes = {}
    for name in sorted(clean):
        x = clean[name]
        if _is_direct_or_indirect(name):
            noisy[name] = torch.clamp_min(x + sigma * (x + 0.05) * d.normal(x.shape), 0.0)
        elif _kind(name) == "color":
            noisy[name] = torch.clamp(x + 0.02 * sigma * d.normal(x.shape), 0.0, 1.0)
        else:
            noisy[name] = x
    noisy["combined"] = _recompose(noisy, groups)
    return noisy


def _demod(x: Tensor, albedo: Tensor) -> Tensor:
    return x / (albedo + DEMOD_EPS)


def encode_pair(noisy: Passes, clean: Passes, mode: str) -> Passes:
    """(noisy, clean) -> {'x', 'y'}: the joint or group network input and
    its target, demodulated by the noisy albedo the network sees."""
    if mode == "joint":
        feats, ys = [], []
        for g in LIGHT_GROUPS:
            dn, inn, cn = group_passes(g)
            albedo = noisy[cn]
            feats += [normalize(dn, _demod(noisy[dn], albedo)),
                      normalize(inn, _demod(noisy[inn], albedo)), albedo]
            ys += [normalize(dn, _demod(clean[dn], albedo)),
                   normalize(inn, _demod(clean[inn], albedo))]
    elif mode == "group":
        dn, inn, cn = group_passes("diffuse")
        albedo = noisy[cn]
        feats = [normalize(dn, _demod(noisy[dn], albedo)),
                 normalize(inn, _demod(noisy[inn], albedo)), albedo]
        ys = [normalize(dn, _demod(clean[dn], albedo)),
              normalize(inn, _demod(clean[inn], albedo))]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    feats += [normalize(a, noisy[a]) for a in AUX_PASSES]
    return {"x": torch.cat(feats, dim=-1), "y": torch.cat(ys, dim=-1)}


def frames(params: dict, seed: int, device) -> List[Passes]:
    """`pool` noisy multi-pass frames, {pass: (H, W, C) fp32} on `device`:
    Fourier-family clean passes with MC noise at `spp` samples."""
    d = draws(seed, device)
    out = []
    for _ in range(params["pool"]):
        clean = generate_clean_passes(d, 1, params["height"], params["width"])
        noisy = add_mc_noise(d, clean, params["spp"])
        out.append({k: v[0].contiguous() for k, v in noisy.items()})
    return out


def training_batch(d: Draws, batch: int, crop: int, mode: str, family: str = "fourier") -> Passes:
    """{'x', 'y'}: one encoded training batch of `batch` crops; one fresh
    Fourier scene an example, one noisy realisation at spp 2^U(1,6)."""
    if family != "fourier":
        raise ValueError(f"the frozen generator makes the fourier family, not {family!r}")
    clean = generate_clean_passes(d, batch, crop, crop)
    spp = 2.0 ** d.uniform((batch, 1, 1, 1), 1.0, 6.0)
    return encode_pair(add_mc_noise(d, clean, spp), clean, mode)


def train_batches(params: dict, seed: int, device, mode: str) -> List[Passes]:
    """`pool` encoded batches, all rows different, from one seeded stream."""
    d = draws(seed, device)
    return [training_batch(d, params["batch"], params["crop"], mode, params["family"])
            for _ in range(params["pool"])]
