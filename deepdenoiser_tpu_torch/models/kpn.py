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
on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepdenoiser_tpu_torch.ops import kpn_apply

Tensor = torch.Tensor


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
        """feats (N,H,W,n_slots*k²) logits, signal (N,H,W,3*n_slots)
        -> (N,H,W,3*n_slots) fp32."""
        k2 = self.kernel_size**2
        if feats.shape[-1] != self.n_slots * k2:
            raise ValueError(f"backbone must emit {self.n_slots * k2} channels, got {feats.shape[-1]}")
        if signal.shape[-1] != 3 * self.n_slots:
            raise ValueError(f"signal must have {3 * self.n_slots} channels, got {signal.shape[-1]}")
        if self.logit_norm:
            taus = self.TEMP_MAX * torch.sigmoid(self.kernel_temp.float())
        outs = []
        for s in range(self.n_slots):
            # the slot's logits as the JAX head takes them, (N,H,W,k²) fp32
            # with the taps last: a strided slice of feats, which the RMS
            # norm's elementwise ops read in place. The softmax's output is
            # contiguous (N,H,W,k²), the layout the filter-apply kernel
            # stages in 16-byte copies; nothing is transposed or gathered.
            logits = feats[..., s * k2 : (s + 1) * k2].float()
            if self.logit_norm:
                rms = torch.sqrt(torch.mean(logits * logits, dim=-1, keepdim=True) + 1e-8)
                logits = logits / rms * taus[s]
            weights = torch.softmax(logits, dim=-1)
            outs.append(
                self.filter_apply(signal[..., 3 * s : 3 * (s + 1)].float(), weights, self.kernel_size)
            )
        return torch.cat(outs, dim=-1)


def kpn_receptive_field(backbone_rf: int, kernel_size: int) -> int:
    """The receptive field of a backbone with a k x k filter head after it."""
    return backbone_rf + kernel_size - 1
