"""Train and eval steps on one card (upstream: the estimator model_fn of
TensorFlow/DeepDenoiser.py — SURVEY.md C16).

The port of deepdenoiser_tpu/training/train.py. A step is forward, loss,
backward (through the KPN backward kernel on the card), global-norm
clipping, Adam or AdamW under the warm-up schedule, and the parameter EMA.
PyTorch runs eagerly and updates in place, so a step mutates the state it
is given and returns it; there is no jit, retracing or buffer donation.

Where the JAX package uses optax, the port matches it step for step:
  * the learning rate is a LambdaLR equal at every step to optax's
    warmup_cosine_decay_schedule / join_schedules of linear + constant,
    evaluated at the pre-increment count (step 0 runs at lr 0 when there
    is warm-up);
  * clipping is optax.clip_by_global_norm's: g * max/||g|| when ||g|| >=
    max, with no epsilon (clip_grad_norm_ adds 1e-6);
  * the `grad_norm` metric is the norm before clipping;
  * torch.optim.Adam / AdamW compute optax's adam / adamw updates (eps
    1e-8 outside the square root, decoupled weight decay at the scheduled
    rate);
  * the EMA is e*d + p*(1-d) after the update.

Data-parallel training over several cards (the JAX package's shard_map +
pmean) is the multi-device slice's: a `mesh` argument raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.config import TrainConfig
from deepdenoiser_tpu_torch.models import factory, layers
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops import losses, metrics

Tensor = torch.Tensor
Batch = Dict[str, Tensor]  # {'x': (N,H,W,Cin), 'y': (N,H,W,Cout)} (+ 'mask', 'y_teacher')


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over several cards comes with the multi-device slice "
            "of the port")


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters, computing in its config's dtype), its
    optimizer and schedule, the step count and the parameter EMA
    ({name: tensor}, None when EMA is off)."""

    step: int
    model: factory.DenoiserModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: Optional[Dict[str, Tensor]]

    @property
    def params(self) -> Dict[str, Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "params": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "ema_params": self.ema_params}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.step = int(d["step"])
        self.model.load_state_dict(d["params"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.scheduler.load_state_dict(d["scheduler"])
        if (d["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and state disagree on whether an EMA is kept")
        if self.ema_params is not None:
            with torch.no_grad():
                for name, t in d["ema_params"].items():
                    self.ema_params[name].copy_(t)


def learning_rate(cfg: TrainConfig, step: int) -> float:
    """The learning rate of update `step` (0-based): optax's schedule."""
    lr, warm = cfg.learning_rate, cfg.warmup_steps
    if cfg.schedule not in ("cosine", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if step < warm:  # linear_schedule(0, lr, warm)
        return lr * step / warm
    if cfg.schedule == "constant":
        return lr
    decay = max(cfg.steps, warm + 1) - warm  # cosine_decay_schedule(lr, decay)
    count = min(step - warm, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))


def make_optimizer(cfg: TrainConfig, params) -> Tuple[torch.optim.Optimizer,
                                                      torch.optim.lr_scheduler.LambdaLR]:
    """Adam (AdamW with weight decay) at base lr 1 under a LambdaLR that
    sets the scheduled rate (LambdaLR evaluates step 0 at once, so an
    unknown schedule raises here); clipping happens in the step."""
    kw = dict(lr=1.0, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.weight_decay > 0:
        opt = torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: learning_rate(cfg, step))


def create_state(model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0,
                 device=None, params: Optional[Dict[str, Any]] = None) -> TrainState:
    """A fresh state on `device` (the card unless the caller asks for the
    CPU). The model starts from `params` (a Flax tree, e.g. the JAX
    package's init carried across) or from factory.init_model with a CPU
    generator seeded by `seed`, so the start does not depend on the device."""
    dev = device_lib.resolve(device)
    if params is None:
        model = factory.init_model(model_cfg, torch.Generator().manual_seed(seed))
    else:
        model = factory.build_model(model_cfg)
        weights_io.load_into(model, params)
    model.to(dev)
    opt, sched = make_optimizer(train_cfg, model.parameters())
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if train_cfg.ema_decay > 0 else None)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched, ema_params=ema)


def _loss_and_metrics(model: Callable, loss_cfg: losses.LossConfig, batch: Batch,
                      scale_weight: float = 0.0, distill_weight: float = 0.0
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
    mask = batch.get("mask")
    if scale_weight > 0.0:
        # per-scale supervision: the composed outputs finest -> coarsest,
        # each coarse one scored against the average-downsampled target
        outs = model(batch["x"], return_scales=True)
        pred = outs[0]
        loss = losses.pass_loss(loss_cfg, pred, batch["y"], mask)
        tgt = batch["y"]
        extra = torch.zeros((), dtype=torch.float32, device=pred.device)
        for o in outs[1:]:
            tgt = layers.avg_downsample(tgt, 2)
            extra = extra + losses.pass_loss(loss_cfg, o, tgt, mask)
        loss = loss + scale_weight * extra / max(len(outs) - 1, 1)
    else:
        pred = model(batch["x"])
        loss = losses.pass_loss(loss_cfg, pred, batch["y"], mask)
    if distill_weight > 0.0 and "y_teacher" in batch:
        # blend with the loss against a frozen teacher's prediction on the
        # same noisy input (the batch carries it)
        loss = (1.0 - distill_weight) * loss + distill_weight * losses.pass_loss(
            loss_cfg, pred, batch["y_teacher"], mask)
    return loss, {"loss": loss, "psnr_encoded": metrics.psnr(pred, batch["y"], data_range=4.0)}


def _apply_update(cfg: TrainConfig, state: TrainState, mets: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Clip, step the optimizer and the schedule, update the EMA; no host
    sync. Returns the metrics with `grad_norm` (before clipping)."""
    params = list(state.model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if cfg.grad_clip_norm > 0:
        limit = torch.as_tensor(cfg.grad_clip_norm, dtype=norm.dtype, device=norm.device)
        torch._foreach_mul_(grads, torch.where(norm < limit, torch.ones_like(norm), limit / norm))
    state.optimizer.step()
    state.scheduler.step()
    if state.ema_params is not None:
        d = cfg.ema_decay
        with torch.no_grad():
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p.detach() for p in state.model.parameters()], alpha=1.0 - d)
    state.step += 1
    return {**mets, "grad_norm": norm}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh=None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, Tensor]]]:
    """step(state, batch) -> (state, metrics): one update, in place. The
    metrics are 0-d tensors on the device (reading them syncs)."""
    _no_mesh(mesh)
    scale_w = train_cfg.scale_supervision_weight if model_cfg.n_scales > 1 else 0.0

    def step(state: TrainState, batch: Batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, mets = _loss_and_metrics(state.model, train_cfg.loss, batch, scale_w,
                                       train_cfg.distill_weight)
        loss.backward()
        mets = _apply_update(train_cfg, state, mets)
        return state, {k: v.detach() for k, v in mets.items()}

    return step


def _with_params(state: TrainState, params: Optional[Dict[str, Tensor]]) -> Callable:
    """The model as a function of `params` (None: its own)."""
    if params is None:
        return state.model
    return lambda x, **kw: torch.func.functional_call(state.model, params, (x,), kw)


def make_full_eval_step(model_cfg: ModelConfig, data_cfg, loss_cfg: losses.LossConfig, mesh=None):
    """eval(state, raw_batch) -> metrics over RAW batches, for the
    parameters and the EMA (prefix 'ema_'): encoded-space loss and PSNR,
    and tonemapped PSNR / SSIM of the decoded and recomposed prediction,
    the numbers the inference side reports; 'noisy_psnr_tm' anchors the
    gain."""
    from deepdenoiser_tpu_torch.data import loader as loader_lib

    _no_mesh(mesh)
    encode = loader_lib.make_batch_encoder(data_cfg)
    decode = loader_lib.make_eval_decoder(data_cfg)
    tm = metrics.tonemap_for_metrics

    @torch.no_grad()
    def evaluate(state: TrainState, raw: Batch) -> Dict[str, Tensor]:
        state.model.eval()
        batch = encode(raw)
        mets: Dict[str, Tensor] = {}
        for prefix, params in (("", None), ("ema_", state.ema_params)):
            if prefix and params is None:
                continue
            pred = _with_params(state, params)(batch["x"])
            mets[prefix + "loss"] = losses.pass_loss(loss_cfg, pred, batch["y"], batch.get("mask"))
            mets[prefix + "psnr_encoded"] = metrics.psnr(pred, batch["y"], data_range=4.0)
            pred_rgb, ref_rgb, noisy_rgb = decode(raw, pred)
            mets[prefix + "psnr_tm"] = metrics.psnr(tm(pred_rgb), tm(ref_rgb))
            mets[prefix + "ssim_tm"] = metrics.ssim(tm(pred_rgb), tm(ref_rgb)).mean()
        mets["noisy_psnr_tm"] = metrics.psnr(tm(noisy_rgb), tm(ref_rgb))
        return mets

    return evaluate


def make_eval_preview(model_cfg: ModelConfig, data_cfg, max_images: int = 4):
    """preview(state, raw_batch) -> (noisy_rgb, denoised_rgb, gt_rgb) for
    the first max_images examples, with the EMA parameters when kept."""
    from deepdenoiser_tpu_torch.data import loader as loader_lib

    encode = loader_lib.make_batch_encoder(data_cfg)
    decode = loader_lib.make_eval_decoder(data_cfg)

    @torch.no_grad()
    def preview(state: TrainState, raw: Batch):
        state.model.eval()
        batch = encode(raw)
        pred = _with_params(state, state.ema_params)(batch["x"])
        pred_rgb, ref_rgb, noisy_rgb = decode(raw, pred)
        k = min(max_images, pred_rgb.shape[0])
        return noisy_rgb[:k], pred_rgb[:k], ref_rgb[:k]

    return preview


def make_eval_step(model_cfg: ModelConfig, loss_cfg: losses.LossConfig, mesh=None,
                   use_ema: bool = False):
    """eval(state, encoded_batch) -> {'loss', 'psnr_encoded'}."""
    _no_mesh(mesh)

    @torch.no_grad()
    def evaluate(state: TrainState, batch: Batch) -> Dict[str, Tensor]:
        state.model.eval()
        params = state.ema_params if use_ema else None
        _, mets = _loss_and_metrics(_with_params(state, params), loss_cfg, batch)
        return mets

    return evaluate
