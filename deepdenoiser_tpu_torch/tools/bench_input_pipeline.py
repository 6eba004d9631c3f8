"""The throughput of the real data path (BASELINE.json:10, end-to-end
training: EXR -> feature pipeline, augmentation, forward and backward)
against the on-device synthesis path, at matched batch, crop and model.

    python -m deepdenoiser_tpu_torch.tools.bench_input_pipeline [--batch 16] [--crop 128] \\
        [--steps 150] [--model flagship-hq] [--shards DIR] [--device cpu]

The port of tools/bench_input_pipeline.py. The port's loader
(data/loader.py: batches built ahead by a pool of threads in the training
process) stands where Grain stood, and the JAX tool's keys are kept so the
two JSON lines line up. Measures, in order:

  * host_iter_batches_per_s      next() of the loader alone (no device);
  * grain_2dispatch_steps_per_s  training/loop.fit's path: a pinned batch
                                 to the device, make_batch_encoder, then
                                 make_train_step;
  * synth_fused_steps_per_s      data/synthetic_device.training_batch
                                 ('mixed' family) then the step: the
                                 pretraining recipe's path;
  * grain_vs_synth               the fit path's rate over the synthesis path's.

Each rate is steps over the host time of --steps steps after one warm-up
step, closed by reading the last step's loss. The JAX tool's
grain_fused_steps_per_s is left out: it compiled the encode and the step
into one XLA program, which eager PyTorch has no counterpart of. Without
--shards a small synthetic corpus (4 frames x 2 spp variants, crop
--crop examples) is built under build/pipe_bench/ in the repo and reused
across runs. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch.config import DataConfig, TrainConfig
from deepdenoiser_tpu_torch.data import loader as loader_lib
from deepdenoiser_tpu_torch.data import prepare, synthetic_device
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS, MODES, REPO_ROOT
from deepdenoiser_tpu_torch.training import loop
from deepdenoiser_tpu_torch.training import train as train_lib

CORPUS_ROOT = REPO_ROOT / "build" / "pipe_bench"
HOST_BATCHES = 60


def _build_corpus(root: Path, crop: int) -> Path:
    """The JAX tool's corpus: 4 synthetic frames of 3 crop x 3 crop with
    spp 4 and 16, cut into joint-mode shards of crop x crop (32 a frame);
    returns the shard dir, reused when it is there."""
    shard_dir = root / f"shards_c{crop}"
    if (shard_dir / "train" / "meta.json").exists():
        return shard_dir
    renders = root / "renders"
    if not (renders / "frame0000").exists():
        print("building synthetic render root...", file=sys.stderr, flush=True)
        prepare.generate_synthetic_render_root(
            renders, n_frames=4, height=3 * crop, width=3 * crop, spps=(4, 16), n_seeds=1, seed=7)
    print("cutting shards...", file=sys.stderr, flush=True)
    dcfg = DataConfig(crop=crop, crops_per_frame=32, batch_size=16, mode="joint", seed=0)
    prepare.prepare_dataset(renders, shard_dir, dcfg)
    return shard_dir


def main(argv: List[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--model", default="flagship-hq", choices=sorted(MODELS))
    p.add_argument("--shards", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    shard_dir = Path(args.shards) if args.shards else _build_corpus(CORPUS_ROOT, args.crop)
    mcfg = MODELS[args.model]
    mode = MODES[mcfg.out_channels]
    dcfg = DataConfig(crop=args.crop, batch_size=args.batch, mode=mode, seed=0)
    tcfg = TrainConfig(steps=args.steps, learning_rate=1e-4, ema_decay=0.999)
    result = {"batch": args.batch, "crop": args.crop, "model": args.model}

    # --- the loader alone --------------------------------------------------
    it = loader_lib.make_iterator(shard_dir / "train", dcfg)
    try:
        next(it)  # prime: the threads start, the shards open
        t0 = time.perf_counter()
        for _ in range(HOST_BATCHES):
            next(it)
        host_rate = HOST_BATCHES / (time.perf_counter() - t0)
    finally:
        it.close()
    result["host_iter_batches_per_s"] = round(host_rate, 2)
    print(f"host iterator: {host_rate:.1f} batches/s", file=sys.stderr, flush=True)

    step = train_lib.make_train_step(mcfg, tcfg)

    def steps_per_s(next_batch, label: str) -> float:
        state = train_lib.create_state(mcfg, tcfg, seed=0, device=dev)
        state, mets = step(state, next_batch())  # warm-up
        float(mets["loss"])
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, mets = step(state, next_batch())
        float(mets["loss"])  # the device has finished every step
        rate = args.steps / (time.perf_counter() - t0)
        print(f"{label}: {rate:.1f} steps/s", file=sys.stderr, flush=True)
        return rate

    # --- loop.fit's path: pinned batch -> device -> encode -> step ----------
    encode = loader_lib.make_batch_encoder(dcfg)
    it = loader_lib.make_iterator(shard_dir / "train", dcfg, pin_memory=dev.type == "cuda")
    try:
        rate2 = steps_per_s(lambda: encode(loop._to_device(next(it), dev)),
                            "loader + encode + step (loop.fit path)")
    finally:
        it.close()
    result["grain_2dispatch_steps_per_s"] = round(rate2, 2)

    # --- the recipe's path: batches made on the device ----------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    synth_rate = steps_per_s(
        lambda: synthetic_device.training_batch(gen, args.batch, args.crop, mode, "mixed"),
        "device batches + step")
    result["synth_fused_steps_per_s"] = round(synth_rate, 2)
    result["grain_vs_synth"] = round(rate2 / max(synth_rate, 1e-9), 3)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
