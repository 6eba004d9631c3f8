"""The training driver (upstream: tf.estimator train_and_evaluate in
DeepDenoiser.py — SURVEY.md C16): config -> data -> step -> checkpoints
-> metrics, with automatic resume and SIGTERM-safe saving.

The port of deepdenoiser_tpu/training/loop.py, on one card. The host loop
pulls raw batches from the loader's threads, moves them to the device
(pinned memory on the card), encodes them there and runs the train step;
it reads the metrics back only when it logs them. Resume restores the
parameters, optimizer, schedule, EMA, step AND the data iterator's state,
so a resumed run continues with the batches an uninterrupted one would
have seen (bitwise on the CPU; on the card cuDNN's convolution backward
may sum in another order from run to run).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from deepdenoiser_tpu_torch import config as config_lib
from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import ExperimentConfig
from deepdenoiser_tpu_torch.data import loader as loader_lib
from deepdenoiser_tpu_torch.data import shards as shards_lib
from deepdenoiser_tpu_torch.training import train as train_lib
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager


class MetricLogger:
    """Scalars to `metrics_<name>.jsonl` (appended, so a resumed run's
    file continues) and stdout; TensorBoard summaries too when
    torch.utils.tensorboard imports."""

    def __init__(self, workdir: Path, name: str = "train"):
        workdir.mkdir(parents=True, exist_ok=True)
        self._f = open(workdir / f"metrics_{name}.jsonl", "a")
        self._name = name
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass  # no tensorboard: the JSONL file is the record
        else:
            self._tb = SummaryWriter(str(workdir / "tb" / name))

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        msg = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
        print(f"[{self._name} step {step}] {msg}", flush=True)

    def log_images(self, step: int, images: Dict[str, np.ndarray]) -> None:
        """TensorBoard image summaries ((N,H,W,C) float [0,1])."""
        if self._tb is not None:
            for k, v in images.items():
                self._tb.add_images(k, v, step, dataformats="NHWC")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _to_device(raw: Mapping[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in raw.items()}


def fit(
    cfg: ExperimentConfig,
    workdir: str | Path,
    shard_dir: Optional[str] = None,
    max_steps: Optional[int] = None,
    device=None,
) -> train_lib.TrainState:
    """Run (or resume) training to cfg.train.steps on one device (the card
    unless `device` says otherwise)."""
    cfg = config_lib.validate_channels(cfg)
    dev = device_lib.resolve(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    shard_dir = shard_dir or cfg.data.shard_dir
    if cfg.data.stats_normalize and not cfg.data.pass_scales:
        # statistics-driven normalization: derive the scales from the
        # training corpus once and freeze them into the saved config, so
        # resume and inference encode exactly as training did
        meta = shards_lib.ShardMeta.from_json((Path(shard_dir) / "train" / "meta.json").read_text())
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, pass_scales=loader_lib.derive_pass_scales(meta)))
    config_lib.save(cfg, workdir / "config.json")

    tcfg, dcfg, mcfg = cfg.train, cfg.data, cfg.model
    encode = loader_lib.make_batch_encoder(dcfg)
    step_fn = train_lib.make_train_step(mcfg, tcfg)
    eval_fn = train_lib.make_full_eval_step(mcfg, dcfg, tcfg.loss)
    preview_fn = train_lib.make_eval_preview(mcfg, dcfg)

    state = train_lib.create_state(mcfg, tcfg, seed=dcfg.seed, device=dev)
    ckpt = CheckpointManager(workdir / tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    train_it = loader_lib.make_iterator(Path(shard_dir) / "train", dcfg, training=True,
                                        pin_memory=dev.type == "cuda")
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state, extra = restored
        if "data_iter" in extra:
            train_it.set_state(extra["data_iter"])
        print(f"resumed from step {state.step}", flush=True)

    logger = MetricLogger(workdir, "train")
    eval_logger = MetricLogger(workdir, "eval")
    stop = {"now": False}

    def _sigterm(_sig, _frm):
        stop["now"] = True

    old_handler = signal.signal(signal.SIGTERM, _sigterm)

    def save(step_num: int) -> None:
        ckpt.save(step_num, state, extra={"data_iter": train_it.get_state(),
                                          "config": config_lib.to_dict(cfg)})

    target = min(tcfg.steps, max_steps) if max_steps else tcfg.steps
    step_num = state.step
    has_validation = (Path(shard_dir) / "validation" / "meta.json").exists()
    try:
        while step_num < target and not stop["now"]:
            batch = encode(_to_device(next(train_it), dev))
            state, mets = step_fn(state, batch)
            step_num += 1
            if step_num % tcfg.log_every == 0 or step_num == target:
                logger.log(step_num, mets)
            if step_num % tcfg.eval_every == 0 and has_validation:
                emets, raw0 = _run_eval(eval_fn, state, shard_dir, dcfg, dev)
                if emets:
                    eval_logger.log(step_num, emets)
                if raw0 is not None:
                    _log_preview(preview_fn, state, raw0, step_num, eval_logger, workdir)
            if step_num % tcfg.checkpoint_every == 0:
                save(step_num)
        save(step_num)
    finally:
        train_it.close()
        ckpt.close()
        logger.close()
        eval_logger.close()
        signal.signal(signal.SIGTERM, old_handler)
    if stop["now"]:
        print(f"SIGTERM: saved at step {step_num} and exiting", flush=True)
    return state


def _run_eval(eval_fn, state, shard_dir, dcfg, dev, max_batches: int = 8):
    """Eval over raw validation batches (encode and decode inside the eval
    step). Returns (mean metrics, the first raw batch for previews)."""
    agg: Dict[str, list] = {}
    first_raw = None
    source = loader_lib.make_dataset(Path(shard_dir) / "validation", dcfg, training=False)
    for i, raw in enumerate(loader_lib.iterate_epoch(source)):
        if i >= max_batches:
            break
        raw = _to_device(raw, dev)
        if first_raw is None:
            first_raw = raw
        for k, v in eval_fn(state, raw).items():
            agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in agg.items()}, first_raw


def _log_preview(preview_fn, state, raw, step, logger: MetricLogger, workdir: Path) -> None:
    """noisy | denoised | GT tonemapped strips, one row per example, to
    TensorBoard (when there) and workdir/previews/ as PNG."""
    from deepdenoiser_tpu_torch.utils import images as img_lib

    noisy, den, gt = (x.float().cpu().numpy() for x in preview_fn(state, raw))
    rows = [
        img_lib.side_by_side(img_lib.tonemap_srgb(noisy[i]), img_lib.tonemap_srgb(den[i]),
                             img_lib.tonemap_srgb(gt[i]))
        for i in range(noisy.shape[0])
    ]
    strip = np.concatenate(rows, axis=0)
    logger.log_images(step, {"noisy_denoised_gt": strip[None]})
    img_lib.save_png(workdir / "previews" / f"step_{step:08d}.png", strip)
