"""Pretrain (or fine-tune, or distil) a zoo model on batches made on the
card, keep the best validation checkpoint, and save the port's checkpoints
(training/checkpoint.py) for tools/export_release_weights.py.

    python -m deepdenoiser_tpu_torch.tools.pretrain_flagship \\
        [--model flagship] [--steps 3000] [--out checkpoints/flagship] \\
        [--teacher NAME] [--init-from weights/NAME_ema_f16.npz] [--device cpu]

The port of tools/pretrain_flagship.py. Each step draws a batch with
data/synthetic_device.training_batch from one torch.Generator on the
device (seeded 42 + the step resumed from), adds the frozen teacher's
prediction as `y_teacher` when --teacher is set (run under no_grad; the
step blends it in by TrainConfig.distill_weight), and runs
training/train.make_train_step. Every --val-every steps the EMA parameters
are scored (psnr_encoded, training/train.make_eval_step) on 4 batches from
generators seeded 987000 + i, which the training stream never draws from;
the best score's state is saved to <out>-best with extra {model, mode,
val_psnr, family}. <out> is resumed from when it holds a checkpoint,
saved every --save-every steps and at the end. Runs on the card unless
--device cpu is given.

The batches come from torch's generators, not threefry: they are other
samples of the same families than the JAX recipe's. Log lines give the
loss and the host time a training step takes, validation and saves left
out.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import transforms, weights_io
from deepdenoiser_tpu_torch.config import TrainConfig
from deepdenoiser_tpu_torch.data import synthetic_device
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops.losses import LossConfig
from deepdenoiser_tpu_torch.training import train as train_lib
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

# The flagship: joint-group bf16 U-Net with a space-to-depth stem (the JAX
# package's __graft_entry__.FLAGSHIP).
FLAGSHIP = ModelConfig(
    backbone="unet", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), base_width=96, depth=3,
    convs_per_level=2, stem_stride=2, act="leaky_relu", compute_dtype="bfloat16",
    predict_residual=True,
)
RGB_SMALL = ModelConfig(
    backbone="unet", in_channels=transforms.rgb_input_channels(),
    out_channels=3, base_width=32, depth=2, convs_per_level=1,
    act="leaky_relu", compute_dtype="bfloat16", predict_residual=True,
)
MULTISCALE = ModelConfig(
    backbone="unet", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), base_width=48, depth=3,
    convs_per_level=2, n_scales=3, act="leaky_relu",
    compute_dtype="bfloat16", predict_residual=True,
)
TIRAMISU = ModelConfig(
    backbone="tiramisu", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), growth_rate=16,
    layers_per_block=4, depth=3, act="leaky_relu",
    compute_dtype="bfloat16", predict_residual=True,
)
KPN = ModelConfig(
    backbone="unet", in_channels=transforms.group_input_channels(),
    out_channels=6, base_width=48, depth=3, convs_per_level=2,
    kernel_prediction=True, kpn_size=5, kpn_slots=2, act="leaky_relu",
    compute_dtype="bfloat16", kpn_logit_norm=True,
)
TIRAMISU_S2D = ModelConfig(
    backbone="tiramisu", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), growth_rate=20,
    layers_per_block=4, depth=3, act="leaky_relu", stem_stride=2,
    up_compress=64, compute_dtype="bfloat16", predict_residual=True,
)
UNET_FULLRES = ModelConfig(
    backbone="unet", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), base_width=64, depth=3,
    convs_per_level=2, stem_stride=1, act="leaky_relu",
    compute_dtype="bfloat16", predict_residual=True,
)
UNET_FULLRES_48 = dataclasses.replace(UNET_FULLRES, base_width=48)
UNET_FULLRES_96 = dataclasses.replace(UNET_FULLRES, base_width=96)
UNET_FULLRES_128 = dataclasses.replace(UNET_FULLRES, base_width=128)
TIRAMISU_FAST = dataclasses.replace(TIRAMISU, up_compress=64)
TIRAMISU_LT2 = dataclasses.replace(TIRAMISU_FAST, layers_top=2)
TIRAMISU_LT1 = dataclasses.replace(TIRAMISU_FAST, layers_top=1)
TIRAMISU_LT2_UC48 = dataclasses.replace(TIRAMISU_FAST, layers_top=2, up_compress=48)
KPN_JOINT = ModelConfig(
    backbone="unet", in_channels=transforms.joint_input_channels(),
    out_channels=transforms.joint_output_channels(), base_width=64, depth=3,
    convs_per_level=2, stem_stride=1, kernel_prediction=True, kpn_size=5,
    kpn_slots=8, kpn_logit_norm=True, act="leaky_relu",
    compute_dtype="bfloat16",
)
KPN_JOINT_S2D = dataclasses.replace(KPN_JOINT, stem_stride=2)
# Every name of the JAX recipe, with the same configuration (aliases name
# runs and -best selections of the same architectures).
MODELS: Dict[str, ModelConfig] = {
    "flagship": FLAGSHIP, "rgb-small": RGB_SMALL,
    "multiscale": MULTISCALE, "tiramisu": TIRAMISU, "kpn": KPN,
    "tiramisu-s2d": TIRAMISU_S2D, "unet-fullres": UNET_FULLRES,
    "tiramisu-fast": TIRAMISU_FAST,
    "flagship-hq-48": UNET_FULLRES_48,
    "flagship-hq-96": UNET_FULLRES_96,
    "flagship-hq-128": UNET_FULLRES_128,
    "flagship-hq": UNET_FULLRES,
    "hq-distill": UNET_FULLRES,
    "kpn-lr2": KPN,
    "tiramisu-lt2": TIRAMISU_LT2,
    "tiramisu-lt1": TIRAMISU_LT1,
    "tiramisu-lt2-uc48": TIRAMISU_LT2_UC48,
    "kpn-joint": KPN_JOINT,
    "kpn-joint-best": KPN_JOINT,
    "kpn-hq": KPN_JOINT,
    "kpn-joint-s2d": KPN_JOINT_S2D,
    "hq-c96": UNET_FULLRES,
    "hq-c128": UNET_FULLRES,
    "hq-distill-r4": UNET_FULLRES,
    "hq-ft-c128": UNET_FULLRES,
    "multiscale-c192": MULTISCALE,
    "tiramisu-ft-c208": TIRAMISU_FAST,
    "hq-ft2-c128": UNET_FULLRES,
    "hq-ft-mc": UNET_FULLRES,
    "hq-ft-mc-best": UNET_FULLRES,
    "flagship-mc": UNET_FULLRES,
    "hq-ft2-c128-best": UNET_FULLRES,
    "kpn-hq-c128-best": KPN_JOINT,
    "multiscale-c192-best": MULTISCALE,
    "flagship-ft-c256-best": FLAGSHIP,
    "tiramisu-ft2-c208-best": TIRAMISU_FAST,
    "tiramisu-ft-c208-best": TIRAMISU_FAST,
    "kpn-hq-c128": KPN_JOINT,
    "flagship-ft-c256": FLAGSHIP,
    "tiramisu-lt1-ft-c208": TIRAMISU_LT1,
    "tiramisu-ft2-c208": TIRAMISU_FAST,
}
MODES = {24: "joint", 6: "group", 3: "rgb"}  # by out_channels
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"
TRAIN_SEED = 42  # + the step resumed from
VAL_SEED = 987_000  # + the validation batch's index
VAL_BATCHES = 4


def mcfg_has_scales(name: str) -> bool:
    return MODELS[name].n_scales > 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=96)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--out", default="checkpoints/flagship")
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--loss", default="l1", choices=["l1", "l2", "smape", "huber"])
    p.add_argument("--grad-weight", type=float, default=0.2)
    p.add_argument("--model", default="flagship", choices=sorted(MODELS))
    p.add_argument("--family", default="mixed", choices=list(synthetic_device.FAMILIES),
                   help="training signal family (data/synthetic_device.training_batch)")
    p.add_argument("--val-every", type=int, default=2000,
                   help="validate on unseen-seed batches of the training families "
                        "every N steps; the best-EMA-PSNR checkpoint is kept at "
                        "<out>-best (0 disables)")
    p.add_argument("--teacher", default=None, choices=sorted(MODELS),
                   help="knowledge distillation: run this frozen zoo member (shipped "
                        "weights/<name>_ema_f16.npz) on every training batch and blend "
                        "its prediction into the loss (TrainConfig.distill_weight)")
    p.add_argument("--distill-weight", type=float, default=0.5,
                   help="teacher share of the loss when --teacher is set")
    p.add_argument("--init-from", default=None,
                   help="release npz to initialize the student from (fine-tune; "
                        "ignored when the workdir resumes)")
    p.add_argument("--save-every", type=int, default=0,
                   help="resume-checkpoint cadence in steps (0 = the "
                        "max(10*log_every, 10k) default)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    return p


def train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        steps=args.steps, warmup_steps=min(200, args.steps // 10),
        learning_rate=args.lr, schedule="cosine", ema_decay=0.999,
        loss=LossConfig(kind=args.loss, gradient_weight=args.grad_weight),
        # per-scale supervision for multi-scale models
        scale_supervision_weight=0.5 if mcfg_has_scales(args.model) else 0.0,
        distill_weight=args.distill_weight if args.teacher else 0.0,
    )


def load_teacher(name: str, mode: str, device: torch.device) -> factory.DenoiserModel:
    """The frozen zoo member `name` with its shipped release weights."""
    t_mcfg = MODELS[name]
    t_mode = MODES[t_mcfg.out_channels]
    if t_mode != mode:
        raise SystemExit(f"teacher mode {t_mode!r} != student mode {mode!r}")
    t_npz = WEIGHTS_DIR / (name.replace("-", "_") + "_ema_f16.npz")
    teacher = factory.build_model(t_mcfg)
    weights_io.load_into(teacher, weights_io.load_release_params(t_npz))
    teacher.to(device).eval().requires_grad_(False)
    return teacher


class _StepClock:
    """Host time of the training steps alone. Validation and saves are
    bracketed by pause/resume; a pause first reads the last step's loss, so
    the device has finished the steps it is charged for."""

    def __init__(self):
        self._t = time.perf_counter()
        self._s = 0.0
        self._n = 0

    def step(self) -> None:
        self._n += 1

    def pause(self, mets) -> float:
        loss = float(mets["loss"])
        self._s += time.perf_counter() - self._t
        return loss

    def resume(self) -> None:
        self._t = time.perf_counter()

    def take_ms(self) -> float:
        """ms a step since the last take (call between pause and resume)."""
        ms = self._s / max(self._n, 1) * 1e3
        self._s, self._n = 0.0, 0
        return ms


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """The recipe's loop. Returns {start, log: [{step, loss, ms_per_step}],
    val: [{step, psnr_encoded}], best_psnr}."""
    dev = device_lib.resolve(args.device)
    mcfg = MODELS[args.model]
    tcfg = train_config(args)
    mode = MODES[mcfg.out_channels]

    params = weights_io.load_release_params(args.init_from) if args.init_from else None
    state = train_lib.create_state(mcfg, tcfg, seed=0, device=dev, params=params)
    if args.init_from:  # create_state copies the loaded parameters as the EMA
        print(f"student initialized from {args.init_from}", flush=True)
    teacher = None
    if args.teacher:
        teacher = load_teacher(args.teacher, mode, dev)
        print(f"distilling from {args.teacher}, weight {args.distill_weight}", flush=True)
    step_fn = train_lib.make_train_step(mcfg, tcfg)

    def batch(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        b = synthetic_device.training_batch(gen, args.batch, args.crop, mode, args.family)
        if teacher is not None:
            with torch.no_grad():
                b["y_teacher"] = teacher(b["x"])
        return b

    # Validation for checkpoint SELECTION (not the quality holdout): the
    # training families, from seeds the training stream never uses.
    eval_step = train_lib.make_eval_step(mcfg, tcfg.loss, use_ema=True)
    val_batches = [
        synthetic_device.training_batch(torch.Generator(device=dev).manual_seed(VAL_SEED + i),
                                        args.batch, args.crop, mode, args.family)
        for i in range(VAL_BATCHES)
    ] if args.val_every else []

    def val_psnr() -> float:
        return sum(float(eval_step(state, b)["psnr_encoded"]) for b in val_batches) / len(val_batches)

    mgr = CheckpointManager(args.out, keep=1)
    restored = mgr.restore_latest(state)
    start = 0
    if restored is not None:
        state = restored[0]
        start = state.step
        print(f"resuming from step {start}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + start)

    best_mgr = CheckpointManager(args.out + "-best", keep=1) if args.val_every else None
    best = -float("inf")
    save_every = args.save_every or max(args.log_every * 10, 10_000)
    extra = {"model": args.model, "mode": mode}
    res: Dict[str, Any] = {"start": start, "log": [], "val": []}
    clock = _StepClock()
    for i in range(start + 1, args.steps + 1):
        state, mets = step_fn(state, batch(gen))
        clock.step()
        do_log = i % args.log_every == 0 or i == args.steps
        do_val = bool(args.val_every) and (i % args.val_every == 0 or i == args.steps)
        do_save = i % save_every == 0 and i != args.steps
        if not (do_log or do_val or do_save):
            continue
        loss = clock.pause(mets)
        if do_log:
            ms = clock.take_ms()
            res["log"].append({"step": i, "loss": loss, "ms_per_step": ms})
            print(f"step {i}/{args.steps} loss={loss:.5f} ({ms:.2f} ms/step)", flush=True)
        if do_val:
            v = val_psnr()
            res["val"].append({"step": i, "psnr_encoded": v})
            marker = ""
            if v > best:
                best = v
                best_mgr.save(i, state, extra={**extra, "val_psnr": v, "family": args.family})
                marker = "  <- best"
            print(f"  val[{i}] psnr_encoded={v:.3f} dB (best {best:.3f}){marker}", flush=True)
        if do_save:
            mgr.save(i, state, extra=extra)
        clock.resume()

    mgr.save(args.steps, state, extra=extra)
    mgr.close()
    if best_mgr is not None:
        best_mgr.close()
        print(f"best val checkpoint at {args.out}-best (psnr {best:.3f})")
    print(f"saved checkpoint to {args.out}")
    res["best_psnr"] = best
    return res


def main(argv: List[str] | None = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
