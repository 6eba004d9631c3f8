"""Kernel-predicting head (upstream: TensorFlow/KernelPrediction.py —
SURVEY.md C14).

The port of deepdenoiser_tpu/models/kpn.py. The backbone emits per-pixel
k×k filter logits; an fp32 softmax makes them a convex combination of the
noisy neighbours, and the filter is applied to the noisy signal, one
3-channel slot at a time.

`apply_per_pixel_kernels` here is the plain PyTorch version of the filter
apply and `apply_per_pixel_kernels_bwd` that of its backward. The head
calls ops/kpn_apply.py's autograd function, which launches the CUDA
kernels for tensors on the card and runs these plain versions for tensors
on the CPU. Each slot's RMS norm, temperature and softmax go through
ops/kpn_softmax.py's autograd function in the same way: one CUDA launch a
slot on the card, its plain version on the CPU.

`logit_bytes` counts the bytes of logits the head reads, from shapes at
their dtype (every forward, every device; `reset_counts()` zeroes it).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepdenoiser_tpu_torch import tracing
from deepdenoiser_tpu_torch.ops import kpn_apply, kpn_softmax

Tensor = torch.Tensor

# bytes of logits the head has read since the last reset (a plain count)
logit_bytes = 0


def reset_counts() -> None:
    global logit_bytes
    logit_bytes = 0


def apply_per_pixel_kernels(noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """Filter `noisy` (N,H,W,C) with per-pixel weights (N,H,W,k*k), one
    spatial kernel shared across channels: a static k² shift-accumulate
    over the zero-padded plane in fp32, taps in the order t = dy*k + dx."""
    n, h, w, c = noisy.shape
    k = kernel_size
    if tuple(weights.shape) != (n, h, w, k * k):
        raise ValueError(f"weights {tuple(weights.shape)} != {(n, h, w, k * k)}")
    p = k // 2
    padded = F.pad(noisy.float(), (0, 0, p, p, p, p))
    wf = weights.float()
    out = torch.zeros((n, h, w, c), dtype=torch.float32, device=noisy.device)
    for dy in range(k):
        for dx in range(k):
            t = dy * k + dx
            out = out + padded[:, dy : dy + h, dx : dx + w, :] * wf[..., t : t + 1]
    return out


def apply_per_pixel_kernels_bwd(
    noisy: Tensor, weights: Tensor, g: Tensor, kernel_size: int, need_noisy: bool = True
) -> Tuple[Optional[Tensor], Tensor]:
    """Adjoint of apply_per_pixel_kernels, the tap loops of the JAX
    package's _kpn_pallas_bwd (kpn_pallas.py:158-184), p = k//2:

      d_w[n,y,x,t]     = sum_c g[n,y,x,c] * zeropad(noisy)[n, y+dy-p, x+dx-p, c]
      d_noisy[n,u,v,c] = sum_t (g*w_t)[n, u+p-dy, v+p-dx, c]   (tap-flipped)

    Returns (d_noisy or None when not `need_noisy`, d_w), fp32."""
    n, h, w, c = noisy.shape
    k = kernel_size
    p = k // 2
    gf, wf = g.float(), weights.float()
    padded = F.pad(noisy.float(), (0, 0, p, p, p, p))
    d_w = []
    d_noisy = torch.zeros((n, h, w, c), dtype=torch.float32, device=noisy.device) if need_noisy else None
    for t in range(k * k):
        dy, dx = t // k, t % k
        d_w.append((gf * padded[:, dy : dy + h, dx : dx + w, :]).sum(dim=-1))
        if need_noisy:
            gw = F.pad(gf * wf[..., t : t + 1], (0, 0, p, p, p, p))
            d_noisy = d_noisy + gw[:, k - 1 - dy : k - 1 - dy + h, k - 1 - dx : k - 1 - dx + w, :]
    return d_noisy, torch.stack(d_w, dim=-1)


class KernelPredictionHead(nn.Module):
    """Backbone features → softmax k×k kernels → filtered signal.

    `logit_norm`: RMS-normalize the logits over the kernel axis and scale
    by a bounded learned temperature τ = 16·sigmoid(kernel_temp) before
    the softmax (the JAX package's round-3 stability fix).

    `filter_apply` is the filter apply; it defaults to the dispatching
    autograd function (kernels on the card, plain versions on the CPU).
    """

    TEMP_MAX = 16.0
    TEMP_INIT = 3.0

    def __init__(self, kernel_size: int = 5, n_slots: int = 1, logit_norm: bool = False):
        super().__init__()
        self.kernel_size, self.n_slots, self.logit_norm = kernel_size, n_slots, logit_norm
        self.filter_apply: Callable[[Tensor, Tensor, int], Tensor] = (
            kpn_apply.apply_per_pixel_kernels
        )
        if logit_norm:
            t0 = math.log(self.TEMP_INIT / (self.TEMP_MAX - self.TEMP_INIT))
            self.kernel_temp = nn.Parameter(torch.full((n_slots,), t0))

    def forward(self, feats: Tensor, signal: Tensor) -> Tensor:
        """feats (N,H,W,n_slots*k²) logits, fp32 or the backbone's compute
        dtype, signal (N,H,W,3*n_slots) -> (N,H,W,3*n_slots) fp32."""
        global logit_bytes
        k2 = self.kernel_size**2
        if feats.shape[-1] != self.n_slots * k2:
            raise ValueError(f"backbone must emit {self.n_slots * k2} channels, got {feats.shape[-1]}")
        if signal.shape[-1] != 3 * self.n_slots:
            raise ValueError(f"signal must have {3 * self.n_slots} channels, got {signal.shape[-1]}")
        taus = self.TEMP_MAX * torch.sigmoid(self.kernel_temp.float()) if self.logit_norm else None
        outs = []
        for s in range(self.n_slots):
            # the slot's logits as the JAX head takes them, (N,H,W,k²) with
            # the taps last: a strided slice of feats, which the norm and
            # softmax read in place (τ stays on the device), in fp32 or, at
            # k = 21, in the backbone's bf16 (kpn_softmax.reads_in_place);
            # other logits are cast to fp32 first. The weights are fp32,
            # contiguous (N,H,W,k²), the layout the filter-apply kernel
            # stages in 16-byte copies and the backward kernel writes the
            # weight gradient in; nothing is transposed or gathered either
            # way. A slot's weights are dropped before the next slot's are
            # made (at k = 21 a slot's are 15.8 GB at the 1080p group plane).
            logits = feats[..., s * k2 : (s + 1) * k2]
            logit_bytes += logits.numel() * logits.element_size()
            if not kpn_softmax.reads_in_place(logits):
                logits = logits.float()
            weights = kpn_softmax.KpnSoftmax.apply(logits, None if taus is None else taus[s])
            del logits
            slot = signal[..., 3 * s : 3 * (s + 1)].float()
            with tracing.span("k1"):
                outs.append(self.filter_apply(slot, weights, self.kernel_size))
            del weights
        return torch.cat(outs, dim=-1)


def kpn_receptive_field(backbone_rf: int, kernel_size: int) -> int:
    """The receptive field of a backbone with a k x k filter head after it."""
    return backbone_rf + kernel_size - 1
