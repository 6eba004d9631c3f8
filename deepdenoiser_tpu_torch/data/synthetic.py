"""Procedural synthetic render-pass generator (SURVEY.md N5).

A copy of generate_clean_passes, add_mc_noise and generate_frame_set from
deepdenoiser_tpu/data/synthetic.py, so the port builds the same Fourier
family frames (same seeds, same numbers) with no import of the JAX
package. The pass sets are recomposition-consistent:

    combined == Σ_g color_g ⊙ (direct_g + indirect_g) + emission + environment

holds for the clean frame and for every noisy realization. Host-side
numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.passes import LIGHT_GROUPS


def _smooth_field(
    rng: np.random.Generator,
    height: int,
    width: int,
    channels: int,
    octaves: int = 4,
    base_freq: float = 2.0,
) -> np.ndarray:
    """Band-limited random field in [0, 1] — cheap value-noise via random
    low-frequency Fourier components. Deterministic given the rng state."""
    yy = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :, None]
    out = np.zeros((height, width, channels), dtype=np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        freq = base_freq * (2.0**o)
        fy = rng.uniform(-freq, freq, size=(1, 1, channels)).astype(np.float32)
        fx = rng.uniform(-freq, freq, size=(1, 1, channels)).astype(np.float32)
        ph = rng.uniform(0, 2 * np.pi, size=(1, 1, channels)).astype(np.float32)
        out += amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        total += amp
        amp *= 0.55
    out /= total
    return (0.5 * (out + 1.0)).astype(np.float32)  # -> [0, 1]


def generate_clean_passes(
    height: int,
    width: int,
    seed: int = 0,
    groups: Sequence[str] = LIGHT_GROUPS,
    hdr_scale: float = 4.0,
) -> Dict[str, np.ndarray]:
    """Ground-truth pass set for one frame, recomposition-consistent."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    for g in groups:
        d_name, i_name, c_name = passes.group_passes(g)
        # Albedo: piecewise-smooth texture in [0, 1]; occasionally near-black
        # regions to exercise the demodulation epsilon guards.
        color = _smooth_field(rng, height, width, 3)
        mask = _smooth_field(rng, height, width, 1) > 0.85
        color = np.where(mask, color * 0.01, color)
        # Illumination: smooth positive HDR field (direct brighter than indirect).
        direct = hdr_scale * _smooth_field(rng, height, width, 3) ** 2.0
        indirect = 0.4 * hdr_scale * _smooth_field(rng, height, width, 3) ** 2.0
        out[c_name] = color
        out[d_name] = direct.astype(np.float32)
        out[i_name] = indirect.astype(np.float32)

    out["emission"] = (0.2 * _smooth_field(rng, height, width, 3) ** 4.0).astype(np.float32)
    out["environment"] = (0.1 * _smooth_field(rng, height, width, 3)).astype(np.float32)

    # Geometry buffers.
    n = _smooth_field(rng, height, width, 3) * 2.0 - 1.0
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    out["normal"] = n.astype(np.float32)
    out["depth"] = (20.0 * _smooth_field(rng, height, width, 1) ** 1.5).astype(np.float32)
    out["alpha"] = np.clip(
        _smooth_field(rng, height, width, 1) * 1.6, 0.0, 1.0
    ).astype(np.float32)

    out["combined"] = recompose_np(out, groups)
    return out


def add_mc_noise(
    clean: Dict[str, np.ndarray],
    spp: int,
    seed: int = 0,
    groups: Sequence[str] = LIGHT_GROUPS,
    base_sigma: float = 1.0,
) -> Dict[str, np.ndarray]:
    """One noisy realization at `spp` samples/pixel.

    Direct/indirect radiance passes get zero-mean, signal-proportional
    Gaussian noise with std ∝ 1/sqrt(spp), clipped at 0 (radiance is
    non-negative). Albedo gets a whisper of noise; normals/depth/alpha
    stay clean — and so do EMISSION and ENVIRONMENT: in Cycles those
    passes are (near-)deterministic evaluations (visible emitters /
    background lookup), which is exactly why the recomposition pipeline
    passes them through undenoised. Noising them here made the fixture
    inconsistent with that contract and capped the measurable PSNR on
    scenes with large sky/emitter regions (found via the r3 spheres
    holdout: 48% sky pinned the whole-frame gain to +0.7 dB while the
    geometry region gained +9 dB). The noisy combined is re-recomposed
    from the noisy passes so the identity still holds.
    """
    rng = np.random.default_rng(seed)
    sigma = base_sigma / np.sqrt(float(spp))
    noisy: Dict[str, np.ndarray] = {}
    for name, x in clean.items():
        p = passes.get(name)
        if p.role in (passes.Role.DIRECT, passes.Role.INDIRECT):
            noise = rng.standard_normal(x.shape).astype(np.float32)
            noisy[name] = np.maximum(x + sigma * (x + 0.05) * noise, 0.0)
        elif p.kind is passes.PassKind.COLOR:
            noise = rng.standard_normal(x.shape).astype(np.float32)
            noisy[name] = np.clip(x + 0.02 * sigma * noise, 0.0, 1.0)
        else:
            noisy[name] = x.copy()
    noisy["combined"] = recompose_np(noisy, groups)
    return noisy


def recompose_np(pass_dict: Dict[str, np.ndarray], groups: Sequence[str] = LIGHT_GROUPS) -> np.ndarray:
    """Numpy twin of transforms.recompose."""
    combined: Optional[np.ndarray] = None

    def acc(c, t):
        return t if c is None else c + t

    for g in groups:
        d, i, c = passes.group_passes(g)
        if d in pass_dict and c in pass_dict:
            radiance = pass_dict[d]
            if i in pass_dict:
                radiance = radiance + pass_dict[i]
            combined = acc(combined, pass_dict[c] * radiance)
    for extra in passes.COMPOSITE_EXTRA:
        if extra in pass_dict:
            combined = acc(combined, pass_dict[extra])
    if combined is None:
        raise ValueError("no recomposable passes")
    return combined.astype(np.float32)


def generate_frame_set(
    height: int,
    width: int,
    seed: int,
    spps: Sequence[int] = (4, 16),
    n_seeds: int = 2,
    groups: Sequence[str] = LIGHT_GROUPS,
):
    """(clean, [noisy...]) mimicking one Blender render job's output:
    ground truth + len(spps) * n_seeds noisy realizations."""
    clean = generate_clean_passes(height, width, seed=seed, groups=groups)
    noisy = [
        add_mc_noise(clean, spp=spp, seed=seed * 1000 + 97 * k + spp, groups=groups)
        for spp in spps
        for k in range(n_seeds)
    ]
    return clean, noisy
