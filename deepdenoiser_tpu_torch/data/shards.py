"""Sharded training-crop store (upstream: TensorFlow/TrainingData.py
serialization — SURVEY.md C6).

A copy of deepdenoiser_tpu/data/shards.py: the same format, so shards
written by either package are read by the other.

Format ("ddshard v1"): a shard directory containing
  meta.json             — version, passes, crop size, shard list + sizes,
                          per-pass corpus statistics (SURVEY.md C7)
  shard-NNNNN.npz       — one compressed npz per shard; key '<role>/<pass>'
                          maps to (n, crop, crop, C) float32/float16 stacks

Random access: (shard_idx, row_idx) pairs; shards are loaded lazily and
LRU-cached, so the loader (data/loader.py) gets O(1) amortized reads over
the global index, which it shuffles itself. Radiance passes are stored float32; bounded passes
(color/normal/alpha) as float16 to halve disk + input bandwidth.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepdenoiser_tpu_torch import passes

SOURCE_PREFIX = "source"
TARGET_PREFIX = "target"
FLAGS_KEY = "flags"  # per-example group-presence vector (SURVEY.md C3)
FORMAT_VERSION = 1

# Bounded-range passes stored half-precision on disk.
_F16_KINDS = (passes.PassKind.COLOR, passes.PassKind.NORMAL, passes.PassKind.ALPHA)


def _disk_dtype(pass_name: str) -> np.dtype:
    return np.float16 if passes.get(pass_name).kind in _F16_KINDS else np.float32


@dataclasses.dataclass
class ShardMeta:
    crop: int
    source_passes: List[str]
    target_passes: List[str]
    shard_sizes: List[int]
    stats: Dict[str, Dict[str, float]]
    version: int = FORMAT_VERSION
    # >0: every example carries a FLAGS_KEY presence vector of this length
    # (one bit per configured light group, in DataConfig.groups order).
    flags_dim: int = 0

    @property
    def n_examples(self) -> int:
        return sum(self.shard_sizes)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ShardMeta":
        d = json.loads(s)
        if d.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported shard format version {d.get('version')}")
        return ShardMeta(**d)


def _shard_path(root: Path, idx: int) -> Path:
    return root / f"shard-{idx:05d}.npz"


class ShardWriter:
    """Accumulates examples and writes fixed-size npz shards."""

    def __init__(
        self,
        root: str | Path,
        crop: int,
        source_passes: Sequence[str],
        target_passes: Sequence[str],
        examples_per_shard: int = 512,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.crop = crop
        self.source_passes = list(source_passes)
        self.target_passes = list(target_passes)
        self.examples_per_shard = examples_per_shard
        self._buf: List[Dict[str, np.ndarray]] = []
        self._sizes: List[int] = []
        self._stats = _StatsAccumulator()
        self._flags_dim: Optional[int] = None

    def add(
        self,
        source: Mapping[str, np.ndarray],
        target: Mapping[str, np.ndarray],
        flags: Optional[Sequence[float]] = None,
    ):
        ex: Dict[str, np.ndarray] = {}
        for p in self.source_passes:
            a = np.asarray(source[p])
            assert a.shape == (self.crop, self.crop, passes.channels(p)), (p, a.shape)
            ex[f"{SOURCE_PREFIX}/{p}"] = a
        for p in self.target_passes:
            a = np.asarray(target[p])
            assert a.shape == (self.crop, self.crop, passes.channels(p)), (p, a.shape)
            ex[f"{TARGET_PREFIX}/{p}"] = a
        if flags is not None:
            f = np.asarray(flags, np.float32)
            assert f.ndim == 1
            if self._flags_dim is None:
                self._flags_dim = f.shape[0]
            assert f.shape[0] == self._flags_dim, (f.shape, self._flags_dim)
            ex[FLAGS_KEY] = f
        else:
            assert self._flags_dim is None, "flags must be given for every example"
        self._stats.update(target)
        self._buf.append(ex)
        if len(self._buf) >= self.examples_per_shard:
            self._flush()

    def _flush(self):
        if not self._buf:
            return
        stacked = {}
        for key in self._buf[0]:
            if key == FLAGS_KEY:
                stacked[key] = np.stack([e[key] for e in self._buf]).astype(np.float32)
                continue
            pass_name = key.split("/")[1]
            stacked[key] = np.stack([e[key] for e in self._buf]).astype(
                _disk_dtype(pass_name)
            )
        np.savez_compressed(_shard_path(self.root, len(self._sizes)), **stacked)
        self._sizes.append(len(self._buf))
        self._buf = []

    def finalize(self) -> ShardMeta:
        self._flush()
        meta = ShardMeta(
            crop=self.crop,
            source_passes=self.source_passes,
            target_passes=self.target_passes,
            shard_sizes=self._sizes,
            stats=self._stats.result(),
            flags_dim=self._flags_dim or 0,
        )
        (self.root / "meta.json").write_text(meta.to_json())
        return meta


class _StatsAccumulator:
    """Per-pass corpus statistics (upstream: DataStatistics.py — C7)."""

    def __init__(self):
        self._n: Dict[str, int] = {}
        self._sum: Dict[str, float] = {}
        self._sumsq: Dict[str, float] = {}
        self._min: Dict[str, float] = {}
        self._max: Dict[str, float] = {}

    def update(self, pass_dict: Mapping[str, np.ndarray]):
        for name, arr in pass_dict.items():
            a = np.asarray(arr, dtype=np.float64)
            self._n[name] = self._n.get(name, 0) + a.size
            self._sum[name] = self._sum.get(name, 0.0) + float(a.sum())
            self._sumsq[name] = self._sumsq.get(name, 0.0) + float((a * a).sum())
            self._min[name] = min(self._min.get(name, np.inf), float(a.min()))
            self._max[name] = max(self._max.get(name, -np.inf), float(a.max()))

    def result(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, n in self._n.items():
            mean = self._sum[name] / n
            var = max(self._sumsq[name] / n - mean * mean, 0.0)
            out[name] = {
                "mean": mean,
                "std": float(np.sqrt(var)),
                "min": self._min[name],
                "max": self._max[name],
                "count": float(n),
            }
        return out


class ShardReader:
    """Random-access reader with an LRU shard cache."""

    def __init__(self, root: str | Path, cache_shards: int = 4):
        self.root = Path(root)
        self.meta = ShardMeta.from_json((self.root / "meta.json").read_text())
        self._offsets = np.cumsum([0] + self.meta.shard_sizes)
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._cache_shards = cache_shards

    def __len__(self) -> int:
        return self.meta.n_examples

    def _load_shard(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        with np.load(_shard_path(self.root, idx)) as z:
            data = {k: z[k] for k in z.files}
        self._cache[idx] = data
        if len(self._cache) > self._cache_shards:
            self._cache.popitem(last=False)
        return data

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """Row i with its STORED dtypes (f16 color/normal/alpha, f32
        radiance/depth — `_disk_dtype`): the fp32 upcast happens on the
        device in `loader.make_batch_encoder`, which halves the host→device
        bytes of the f16 passes. Rows may be views into the LRU shard
        cache: downstream transforms copy before mutating (augment.apply_d4
        does; the loader's batch stack always copies)."""
        if not 0 <= i < len(self):
            raise IndexError(i)
        shard = int(np.searchsorted(self._offsets, i, side="right") - 1)
        row = i - int(self._offsets[shard])
        data = self._load_shard(shard)
        return {k: v[row] for k, v in data.items()}
