"""prepare-data: rendered EXR frame directories -> training-crop shards
(upstream: TensorFlow/TrainingData.py main — SURVEY.md C6).

The port of deepdenoiser_tpu/data/prepare.py. Disk contract consumed here
(produced by the Blender batch scripts, blender/ in this repo, or the
synthetic generator):

    render_root/
      <frame_id>/
        ground_truth/        # pass-EXR dir at high spp
        spp<N>_seed<K>/      # noisy variants (any dir name != ground_truth)

Every (crop position x noisy variant) pair becomes one training example
(source = noisy crops, target = clean crops). Crop positions are drawn
deterministically from the frame name and `DataConfig.seed`, frames are
split train/validation by hash, and per-pass corpus statistics go into
meta.json — the same examples, in the same order, as the JAX package
writes. Host-side numpy.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.config import DataConfig
from deepdenoiser_tpu_torch.data import exr, shards, synthetic

GT_DIR = "ground_truth"


def default_source_passes(groups: Sequence[str] = passes.LIGHT_GROUPS) -> List[str]:
    out: List[str] = []
    for g in groups:
        out.extend(passes.group_passes(g))
    out += list(passes.COMPOSITE_EXTRA) + list(passes.AUX_PASSES) + ["combined"]
    return out


def default_target_passes(groups: Sequence[str] = passes.LIGHT_GROUPS) -> List[str]:
    out: List[str] = []
    for g in groups:
        out += list(passes.group_passes(g))
    out += ["combined"]
    return out


def _frame_dirs(render_root: Path) -> List[Path]:
    return sorted(
        p for p in render_root.iterdir() if p.is_dir() and (p / GT_DIR).is_dir()
    )


def _is_validation(frame_id: str, fraction: float) -> bool:
    h = int.from_bytes(hashlib.sha1(frame_id.encode()).digest()[:4], "big")
    return (h / 2**32) < fraction


def _crop_positions(
    rng: np.random.Generator, h: int, w: int, crop: int, n: int
) -> List[Tuple[int, int]]:
    ys = rng.integers(0, max(h - crop, 0) + 1, size=n)
    xs = rng.integers(0, max(w - crop, 0) + 1, size=n)
    return list(zip(ys.tolist(), xs.tolist()))


def _crop(d: Mapping[str, np.ndarray], y: int, x: int, c: int) -> Dict[str, np.ndarray]:
    return {k: v[y : y + c, x : x + c] for k, v in d.items()}


def prepare_dataset(
    render_root: str | Path,
    out_dir: str | Path,
    cfg: DataConfig,
    examples_per_shard: int = 512,
) -> Dict[str, shards.ShardMeta]:
    """EXR render root -> {train: meta, validation: meta} shard dirs."""
    render_root = Path(render_root)
    out_dir = Path(out_dir)
    src_passes = default_source_passes(cfg.groups)
    tgt_passes = default_target_passes(cfg.groups)

    writers = {
        split: shards.ShardWriter(
            out_dir / split, cfg.crop, src_passes, tgt_passes, examples_per_shard
        )
        for split in ("train", "validation")
    }

    frames = _frame_dirs(render_root)
    if not frames:
        raise FileNotFoundError(f"no frame dirs with {GT_DIR}/ under {render_root}")

    for frame_dir in frames:
        split = (
            "validation"
            if _is_validation(frame_dir.name, cfg.validation_fraction)
            else "train"
        )
        gt = exr.load_frame_dir(
            frame_dir / GT_DIR,
            wanted=tgt_passes + list(passes.AUX_PASSES),
            strict=not cfg.use_flags,
        )
        # Feature flags: a scene may lack some light groups entirely. With
        # use_flags the missing passes are zero-filled (contributing 0 to
        # recomposition) and a presence vector over cfg.groups is stored
        # per example, which the encoder turns into flag planes and loss
        # masks.
        flags = None
        if cfg.use_flags:
            present = [all(p in gt for p in passes.group_passes(g)) for g in cfg.groups]
            flags = [1.0 if b else 0.0 for b in present]
            h0, w0 = next(iter(gt.values())).shape[:2]
            _zero_fill(gt, tgt_passes, h0, w0)
        variants = sorted(
            p for p in frame_dir.iterdir() if p.is_dir() and p.name != GT_DIR
        )
        h, w = next(iter(gt.values())).shape[:2]
        if h < cfg.crop or w < cfg.crop:
            raise ValueError(f"{frame_dir}: frame {h}x{w} smaller than crop {cfg.crop}")
        seed = int.from_bytes(hashlib.sha1(frame_dir.name.encode()).digest()[4:8], "big")
        rng = np.random.default_rng((cfg.seed, seed))
        positions = _crop_positions(rng, h, w, cfg.crop, cfg.crops_per_frame)

        for variant in variants:
            noisy = exr.load_frame_dir(variant, wanted=src_passes, strict=not cfg.use_flags)
            if cfg.use_flags:
                _zero_fill(noisy, src_passes, h, w)
            for y, x in positions:
                writers[split].add(
                    _crop(noisy, y, x, cfg.crop), _crop(gt, y, x, cfg.crop), flags
                )

    return {split: w.finalize() for split, w in writers.items()}


def _zero_fill(
    pass_dict: Dict[str, np.ndarray], wanted: Sequence[str], h: int, w: int
) -> None:
    for name in wanted:
        if name not in pass_dict:
            pass_dict[name] = np.zeros((h, w, passes.channels(name)), np.float32)


def generate_synthetic_render_root(
    root: str | Path,
    n_frames: int = 4,
    height: int = 128,
    width: int = 128,
    spps: Sequence[int] = (4, 16),
    n_seeds: int = 1,
    seed: int = 0,
    groups: Sequence[str] = passes.LIGHT_GROUPS,
) -> Path:
    """Write a synthetic (Fourier family) EXR render root matching the disk
    contract above."""
    root = Path(root)
    for f in range(n_frames):
        clean, noisy_list = synthetic.generate_frame_set(
            height, width, seed=seed * 1000 + f, spps=spps, n_seeds=n_seeds, groups=groups,
        )
        frame_dir = root / f"frame{f:04d}"
        exr.save_frame_dir(frame_dir / GT_DIR, clean)
        idx = 0
        for spp in spps:
            for k in range(n_seeds):
                exr.save_frame_dir(frame_dir / f"spp{spp}_seed{k}", noisy_list[idx])
                idx += 1
    return root
