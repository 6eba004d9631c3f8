"""Plain reference of the first training steps: forward, loss, backward by
autograd, global-norm clipping, Adam under the warm-up + cosine schedule.

Frozen from deepdenoiser_tpu_torch/ops/losses.py and training/train.py at
commit 903e8b8 and written again in plain torch:
  * loss: mean of |p - t| (or the configured difference) plus
    gradient_weight * (|dy p - dy t| + |dx p - dx t|) over forward
    differences zero-padded at the far edge; |x| differentiates as +1 at 0;
  * the learning rate of update s (0-based): lr * s / warmup during the
    warm-up, then lr * (1 + cos(pi * min(s - warmup, decay) / decay)) / 2
    with decay = max(steps, warmup + 1) - warmup;
  * clipping: g * max / ||g|| where ||g|| >= max (no epsilon);
  * Adam: m, v with beta1, beta2; p -= lr / (1 - beta1^t) * m /
    (sqrt(v) / sqrt(1 - beta2^t) + eps), eps 1e-8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _abs(x: Tensor) -> Tensor:
    return torch.where(x >= 0, x, -x)


def _difference(kind: str, p: Tensor, t: Tensor, eps: float) -> Tensor:
    if kind == "l1":
        return _abs(p - t)
    if kind == "l2":
        return (p - t) ** 2
    if kind == "smape":
        return _abs(p - t) / (_abs(p) + _abs(t) + eps)
    if kind == "huber":
        d = _abs(p - t)
        return torch.where(d <= 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError(kind)


def _grads(x: Tensor):
    dy = F.pad(x[:, 1:] - x[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))
    return dy, dx


def pass_loss(loss: Mapping, pred: Tensor, target: Tensor) -> Tensor:
    diff = _difference(loss["kind"], pred, target, loss["eps"])
    if loss["gradient_weight"] > 0:
        (pdy, pdx), (tdy, tdx) = _grads(pred), _grads(target)
        diff = diff + loss["gradient_weight"] * (
            _difference(loss["gradient_kind"], pdy, tdy, loss["eps"])
            + _difference(loss["gradient_kind"], pdx, tdx, loss["eps"]))
    if loss["ms_ssim_weight"] > 0:
        raise ValueError("the reference has no MS-SSIM term")
    return diff.mean()


def learning_rate(train: Mapping, step: int) -> float:
    lr, warm = train["learning_rate"], train["warmup_steps"]
    if step < warm:
        return lr * step / warm
    if train["schedule"] == "constant":
        return lr
    decay = max(train["steps"], warm + 1) - warm
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step - warm, decay) / decay))


def run_steps(net: Callable[[Dict[str, Tensor], Tensor], Tensor], params: Dict[str, Tensor],
              train: Mapping, batches: Sequence[Mapping[str, Tensor]]) -> Dict[str, object]:
    """Train `params` (leaf tensors, requires_grad) in place over `batches`,
    one update a batch. Returns {'loss': [per step], 'grad1': {leaf: the
    clipped gradient of the first step}}."""
    if train["weight_decay"] != 0:
        raise ValueError("the reference has no weight decay")
    names = sorted(params)
    leaves = [params[n] for n in names]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2 = train["beta1"], train["beta2"]
    losses: List[float] = []
    grad1 = None
    for s, batch in enumerate(batches):
        loss = pass_loss(train["loss"], net(params, batch["x"]), batch["y"])
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        limit = train["grad_clip_norm"]
        if limit > 0 and norm >= limit:
            grads = [g * (limit / norm) for g in grads]
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr = learning_rate(train, s)
        t = s + 1
        with torch.no_grad():
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = vi.sqrt() / math.sqrt(1 - b2 ** t) + 1e-8
                p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
    return {"loss": losses, "grad1": grad1}
