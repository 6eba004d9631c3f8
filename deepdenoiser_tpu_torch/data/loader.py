"""Input pipeline (upstream: the tf.data input_fn of DeepDenoiser.py —
SURVEY.md C9): shard reader -> deterministic shuffle per epoch -> D4
augmentation -> batch, with a checkpointable iterator state.

The port of deepdenoiser_tpu/data/loader.py without Grain. Batches are
fully determined by (DataConfig.seed, epoch): epoch e visits the examples
in the order np.random.default_rng((seed, e)).permutation(n), cut into
batches of batch_size (the remainder dropped), and example i of epoch e is
augmented by np.random.default_rng((seed, e, i)). So a batch does not
depend on how many threads made it, and an iterator resumed from
`get_state()` ({epoch, position}) hands out the batches an uninterrupted
one would. Grain's own shuffle order is not reproduced: the two packages
visit the same examples per epoch in different orders.

Two ways to split the data, for two kinds of parallel reader:
  * host_count / host_index, the JAX package's per-host sharding: the
    example index space is sliced [host_index::host_count] before the
    shuffle, and each host makes batches of batch_size from its slice;
  * share=(r, n), data-parallel ranks (training/loop.fit): every rank takes
    the same epoch order and reads rows [r*B/n, (r+1)*B/n) of each global
    batch of B, augmented as the one-rank run augments them, so n ranks
    together see exactly the batches one rank would.

Batches are built ahead in the main process by a pool of threads
(`read_threads` of them, 0 = min(4, usable CPUs)): the shard reads, flips
and stacks are numpy copies, which run without the GIL. The threads touch
numpy only and hand over RAW pass crops in their stored dtypes (pinned on
the card's host). Encoding (upcast, demodulation, log, concat) runs on the
device: `make_batch_encoder`, which `make_eval_decoder` mirrors for the
tonemapped eval metrics.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.config import DataConfig
from deepdenoiser_tpu_torch.data import augment, shards

Tensor = torch.Tensor


class BatchSource:
    """Batch b of epoch e, `source[(e, b)]`: {key: (batch, ...) tensor} in
    the stored dtypes. Safe to call from several threads. host_count,
    host_index and share: see the module docstring; drop_remainder=False
    keeps the last, short batch of an epoch."""

    def __init__(self, shard_dir: str | Path, cfg: DataConfig, training: bool = True,
                 host_count: int = 1, host_index: int = 0, drop_remainder: bool = True,
                 share: Tuple[int, int] = (0, 1)):
        self.seed, self.batch_size = cfg.seed, cfg.batch_size
        self.training, self.augment = training, training and cfg.augment
        rank, ranks = share
        if not 0 <= rank < ranks or self.batch_size % ranks:
            raise ValueError(f"share {share}: batch_size {self.batch_size} must divide into "
                             f"{ranks} ranks")
        self.share = share
        self._reader = shards.ShardReader(shard_dir)
        self._lock = threading.Lock()  # the reader's shard cache
        self._index = np.arange(len(self._reader))[host_index::host_count]
        self.n_examples = len(self._index)
        per_epoch = self.n_examples / self.batch_size
        self.batches_per_epoch = int(per_epoch) if drop_remainder else math.ceil(per_epoch)
        self._order = (None, None)  # (epoch, permutation)

    def order(self, epoch: int) -> np.ndarray:
        """The example order of `epoch` (indices into the shard store)."""
        if not self.training:
            return self._index
        cached_epoch, perm = self._order
        if cached_epoch != epoch:
            perm = self._index[np.random.default_rng((self.seed, epoch)).permutation(self.n_examples)]
            self._order = (epoch, perm)
        return perm

    def example(self, epoch: int, i: int) -> Dict[str, np.ndarray]:
        with self._lock:
            ex = self._reader[i]
        if self.augment:
            ex = augment.augment_example(ex, np.random.default_rng((self.seed, epoch, i)))
        return ex

    def batch(self, epoch: int, b: int) -> Dict[str, np.ndarray]:
        rank, ranks = self.share
        per = self.batch_size // ranks
        start = b * self.batch_size + rank * per
        idx = self.order(epoch)[start : min(start + per, (b + 1) * self.batch_size)]
        exs = [self.example(epoch, int(i)) for i in idx]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}

    def __getitem__(self, key) -> Dict[str, Tensor]:
        return {k: torch.from_numpy(v) for k, v in self.batch(*key).items()}

    def __len__(self) -> int:
        return self.batches_per_epoch


class BatchIterator:
    """Infinite training-batch iterator with get_state()/set_state(). The
    state counts the batches handed out, not those built ahead."""

    def __init__(self, source: BatchSource, threads: int, prefetch: int, pin_memory: bool):
        self.source, self.threads, self.prefetch = source, threads, prefetch
        self.pin_memory = pin_memory
        self.epoch = self.position = 0
        self._pool = None
        self._ahead = collections.deque()  # futures of the next batches, in order
        self._next_key = (0, 0)  # the key of the batch after the last one queued

    def get_state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "position": self.position}

    def set_state(self, state: Mapping[str, int]) -> None:
        self.close()
        self.epoch, self.position = int(state["epoch"]), int(state["position"])

    def __iter__(self) -> "BatchIterator":
        return self

    def _build(self, epoch: int, b: int) -> Dict[str, Tensor]:
        batch = self.source[(epoch, b)]
        if self.pin_memory:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def __next__(self) -> Dict[str, Tensor]:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.threads, thread_name_prefix="loader")
            self._next_key = (self.epoch, self.position)
        while len(self._ahead) < self.prefetch:
            e, b = self._next_key
            self._ahead.append(self._pool.submit(self._build, e, b))
            self._next_key = (e + 1, 0) if b + 1 == self.source.batches_per_epoch else (e, b + 1)
        batch = self._ahead.popleft().result()
        self.position += 1
        if self.position == self.source.batches_per_epoch:
            self.epoch, self.position = self.epoch + 1, 0
        return batch

    def close(self) -> None:
        """Stop the threads (a later next() starts them again)."""
        if self._pool is not None:
            for f in self._ahead:
                f.cancel()
            self._pool.shutdown(wait=True)
            self._pool = None
            self._ahead.clear()


def make_dataset(shard_dir: str | Path, cfg: DataConfig, training: bool = True,
                 host_count: int = 1, host_index: int = 0, drop_remainder: bool = True,
                 share: Tuple[int, int] = (0, 1)) -> BatchSource:
    """The batch source over a shard dir; iterating it gives epoch 0's
    batches in the calling thread (the eval path)."""
    return BatchSource(shard_dir, cfg, training, host_count, host_index, drop_remainder, share)


def iterate_epoch(source: BatchSource, epoch: int = 0) -> Iterator[Dict[str, Tensor]]:
    for b in range(source.batches_per_epoch):
        yield source[(epoch, b)]


def make_iterator(shard_dir: str | Path, cfg: DataConfig, training: bool = True,
                  host_count: int = 1, host_index: int = 0, pin_memory: bool = False,
                  share: Tuple[int, int] = (0, 1)) -> BatchIterator:
    """Infinite batch iterator over a shard dir, built ahead by threads."""
    source = BatchSource(shard_dir, cfg, training, host_count, host_index, share=share)
    if source.batches_per_epoch == 0:
        raise ValueError(f"{shard_dir}: {source.n_examples} examples make no batch of "
                         f"{cfg.batch_size}")
    threads = cfg.read_threads or min(4, len(os.sched_getaffinity(0)))
    return BatchIterator(source, threads, cfg.prefetch_batches or 8, pin_memory)


# ---------------------------------------------------------------------------
# On-device batch encoding (raw pass crops -> network tensors)
# ---------------------------------------------------------------------------


def _src(batch: Mapping[str, Tensor], name: str) -> Tensor:
    # rows arrive in their stored dtype (f16 for bounded passes); the
    # upcast happens wherever the batch lies, on the device in training
    return torch.as_tensor(batch[f"{shards.SOURCE_PREFIX}/{name}"]).float()


def _tgt(batch: Mapping[str, Tensor], name: str) -> Tensor:
    return torch.as_tensor(batch[f"{shards.TARGET_PREFIX}/{name}"]).float()


def make_batch_encoder(cfg: DataConfig, aux: Sequence[str] = passes.AUX_PASSES):
    """Returns encode(batch of raw crops) -> {'x', 'y'} (+ 'mask' with
    use_flags), on the batch's device.

    group mode: x = encoded noisy group inputs (log-demod direct/indirect,
    albedo, aux); y = clean direct/indirect encoded with the SAME (noisy)
    albedo, so the demod/remod round trip at inference reuses the albedo
    the network saw. joint mode: every group's, in cfg.groups order, plus
    one flag plane per group and a loss mask with use_flags. rgb mode:
    x = encoded noisy combined + albedo + aux (no alpha); y = log combined.
    """
    aux = tuple(aux)
    scales = dict(cfg.pass_scales) or None
    ex = transforms.radiance_exposure(scales)

    def target(batch, g, albedo):
        d_name, i_name, _ = passes.group_passes(g)
        return [transforms.normalize(n, transforms.demodulate(_tgt(batch, n), albedo), ex)
                for n in (d_name, i_name)]

    if cfg.mode == "group":
        group = cfg.group

        def encode_group(batch: Mapping[str, Tensor]) -> Dict[str, Tensor]:
            src = {n: _src(batch, n) for n in list(passes.group_passes(group)) + list(aux)}
            x = transforms.encode_group_inputs(src, group, aux, scales=scales)
            y = torch.cat(target(batch, group, src[passes.group_passes(group)[2]]), dim=-1)
            return {"x": x, "y": y}

        return encode_group

    if cfg.mode == "joint":
        groups = tuple(cfg.groups)

        def encode_joint(batch: Mapping[str, Tensor]) -> Dict[str, Tensor]:
            names = [n for g in groups for n in passes.group_passes(g)] + list(aux)
            src = {n: _src(batch, n) for n in names}
            x = transforms.encode_joint_inputs(src, groups, aux, scales=scales)
            ys = [t for g in groups for t in target(batch, g, src[passes.group_passes(g)[2]])]
            out = {"x": x, "y": torch.cat(ys, dim=-1)}
            if cfg.use_flags:
                # one constant plane per group says which groups are real;
                # the mask zeroes the 6 output channels of each missing one
                flags = torch.as_tensor(batch[shards.FLAGS_KEY]).float()  # (N, G)
                n, h, w = x.shape[:3]
                planes = flags[:, None, None, :].expand(n, h, w, flags.shape[-1])
                out["x"] = torch.cat([x, planes], dim=-1)
                out["mask"] = flags.repeat_interleave(6, dim=-1)[:, None, None, :]
            return out

        return encode_joint

    if cfg.mode == "rgb":

        def encode_rgb(batch: Mapping[str, Tensor]) -> Dict[str, Tensor]:
            src = {n: _src(batch, n) for n in ["combined", "diffuse_color"] + list(aux)}
            x = transforms.encode_rgb_inputs(
                src, aux=tuple(a for a in aux if a != "alpha"), scales=scales)
            y = transforms.normalize("combined", _tgt(batch, "combined"), ex)
            return {"x": x, "y": y}

        return encode_rgb

    raise ValueError(f"unknown data mode {cfg.mode!r}")


def derive_pass_scales(meta: shards.ShardMeta) -> tuple:
    """Statistics-driven normalization scales from the corpus stats in
    meta.json: depth pre-scaled by 1/mean(depth), and the shared radiance
    exposure 1/mean(combined) (transforms.RADIANCE_SCALE_KEY). Returns the
    DataConfig.pass_scales tuple that training freezes into its config."""
    out = []
    depth_stats = meta.stats.get("depth")
    if depth_stats and depth_stats.get("mean", 0.0) > 0.0:
        out.append(("depth", 1.0 / float(depth_stats["mean"])))
    rad_stats = meta.stats.get("combined")
    if rad_stats and rad_stats.get("mean", 0.0) > 0.0:
        out.append((transforms.RADIANCE_SCALE_KEY, 1.0 / float(rad_stats["mean"])))
    return tuple(out)


def make_eval_decoder(cfg: DataConfig):
    """Returns decode(raw_batch, pred) -> (pred_rgb, ref_rgb, noisy_rgb) in
    the raw radiance domain (NHWC), mirroring the inference pipeline's
    decode and recompose, so training-eval tonemapped PSNR/SSIM compare
    with the inference-side numbers."""
    scales = dict(cfg.pass_scales) or None

    if cfg.mode == "joint":
        groups = tuple(cfg.groups)

        def decode_joint(batch: Mapping[str, Tensor], pred: Tensor):
            src = {n: _src(batch, n) for g in groups for n in passes.group_passes(g)}
            out = dict(transforms.decode_joint_outputs(pred, src, groups, scales=scales))
            for g in groups:
                c_name = passes.group_passes(g)[2]
                out[c_name] = src[c_name]
            for extra in passes.COMPOSITE_EXTRA:
                if f"{shards.SOURCE_PREFIX}/{extra}" in batch:
                    out[extra] = _src(batch, extra)  # noisy pass-through, as inference
            pred_rgb = transforms.recompose(out, groups)
            return pred_rgb, _tgt(batch, "combined"), _src(batch, "combined")

        return decode_joint

    if cfg.mode == "group":
        d_name, i_name, c_name = passes.group_passes(cfg.group)

        def decode_group(batch: Mapping[str, Tensor], pred: Tensor):
            albedo = _src(batch, c_name)
            dec = transforms.decode_group_outputs(pred, albedo, scales=scales)
            pred_rgb = albedo * (dec["direct"] + dec["indirect"])
            ref_rgb = _tgt(batch, c_name) * (_tgt(batch, d_name) + _tgt(batch, i_name))
            noisy_rgb = albedo * (_src(batch, d_name) + _src(batch, i_name))
            return pred_rgb, ref_rgb, noisy_rgb

        return decode_group

    if cfg.mode == "rgb":

        def decode_rgb(batch: Mapping[str, Tensor], pred: Tensor):
            return (transforms.decode_rgb_outputs(pred, scales), _tgt(batch, "combined"),
                    _src(batch, "combined"))

        return decode_rgb

    raise ValueError(f"unknown data mode {cfg.mode!r}")
