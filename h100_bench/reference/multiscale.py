"""Plain reference of the multi-scale UNet denoiser with its residual head,
in float32, or with every convolution's operands rounded to float8 (the
control of a bfloat16 configuration).

Written from deepdenoiser_tpu_torch/models/multiscale.py and
models/factory.py without modules. The UNet, its parameters (the release
file's flat Flax paths, "UNet_0/ConvStack_0/ConvBlock_0/Conv_0/kernel",
HWIO), the float8 rounding and the signal gather are reference/unet.py's.
With S scales, pool the 2x2 average pool, up the nearest x2 upsample and
U the UNet, its parameters shared by every scale:
  * pyramid: x_0 = x, x_s = pool(x_(s-1)), s = 1 .. S-1;
  * each scale: pred_s = U(x_s);
  * compose, coarse to fine: out_(S-1) = pred_(S-1),
    out_s = pred_s + up(out_(s+1) - pool(pred_s)): the coarse output
    replaces the low-frequency band of the finer prediction;
  * head: out_0 plus the 24 signal channels of x.
The input's bottom and right edges are first padded (with zeros) to the
multiple 2**depth * 2**(S-1), so that every scale's UNet sees a size it
divides, and the output is cropped back to the input's size.
Departures from Vogels et al., "Denoising with Kernel Prediction and
Asymmetric Loss Functions" (SIGGRAPH 2018), whose multi-scale architecture
and scale compositor this follows: the compositor's blend weight is fixed
at 1, where the paper learns a per-pixel weight; each scale is a residual
UNet, where the paper predicts kernels; the pyramid is built by 2x2
average pools and the coarse output upsampled by nearest x2.
`halo` is the certified one-sided receptive field, by the same interval
arithmetic as models/multiscale.multiscale_rf_state (263 pixels at the
preset unet-multiscale), rounded up to the multiple (288 there), as the
program's plan rounds it. `multiple` is the size the plane divides, the
UNet's 2**depth at the coarsest scale; the benchmark's frames driver and
the counter plan the plane with it, so `network` adds no zero rows to a
planned plane. The backbone's rows (`count_backbone`) and the seeded
parameters (`param_shapes`) are the UNet's; the pyramid and the compose
are counted by counts.py, which wraps the backbone in scales.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Mapping

import torch
import torch.nn.functional as F

from h100_bench.reference.unet import (count_backbone, load_params, param_shapes, signal,
                                       to_device, unet)

__all__ = ["load_params", "to_device", "network", "halo", "multiple", "count_backbone",
           "param_shapes"]

Tensor = torch.Tensor


def multiple(model: Mapping) -> int:
    """The size every scale's UNet divides: 2**depth at the coarsest scale."""
    return 2 ** model["depth"] * model["stem_stride"] * 2 ** (model["n_scales"] - 1)


def _pool(x: Tensor) -> Tensor:
    """2x2 average pool of an NHWC tensor."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _up(x: Tensor) -> Tensor:
    """Nearest x2 upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def multiscale(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """(N,H,W,Cin) fp32, H and W multiples of `multiple(model)` -> the
    composed (N,H,W,Cout) fp32 under the head."""
    pyramid = [x]
    for _ in range(model["n_scales"] - 1):
        pyramid.append(_pool(pyramid[-1]))
    preds = [unet(p, xs, model, f8) for xs in pyramid]
    out = preds[-1]
    for pred in reversed(preds[:-1]):
        out = pred + _up(out - _pool(pred))
    return out


def network(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """The denoiser's forward: (N,H,W,Cin) fp32 encoded input -> (N,H,W,Cout)."""
    if (model["backbone"] != "unet" or model["n_scales"] < 2 or model["stem_stride"] != 1
            or model["kernel_prediction"] or not model["predict_residual"]):
        raise ValueError("this reference covers multi-scale residual UNet models "
                         "with a stride-1 stem")
    h, w = x.shape[1:3]
    m = multiple(model)
    xp = F.pad(x, (0, 0, 0, -(-w // m) * m - w, 0, -(-h // m) * m - h))
    return multiscale(p, xp, model, f8)[:, :h, :w] + signal(model, x)


def certified_halo(model: Mapping) -> int:
    """Certified one-sided receptive field (pixels) of the model: each
    scale's path (its pools, the UNet, its upsamples back, and, below the
    coarsest, the compose's pool and upsample of its prediction), merged
    by the larger bound on each side."""

    def conv(s, k=3):
        a, bl, br = s
        d = Fraction(k - 1, 2) * a
        return a, bl + d, br + d

    def down(s, k=3):
        a, bl, br = s
        pad_low = (k - 2) // 2
        return 2 * a, bl + pad_low * a, br + (k - 1 - pad_low) * a

    def pool(s):
        a, bl, br = s
        return 2 * a, bl, br + a

    def up(s):
        a, bl, br = s
        return a / 2, bl + a / 2, br

    def u_net(s):
        for _ in range(model["convs_per_level"]):
            s = conv(s)
        for _ in range(model["depth"]):
            s = down(s)
            for _ in range(model["convs_per_level"]):
                s = conv(s)
        for _ in range(model["depth"]):
            s = conv(up(s))
            for _ in range(model["convs_per_level"]):
                s = conv(s)
        return s

    bl = br = Fraction(0)
    n = model["n_scales"]
    for i in range(n):
        s = (Fraction(1), Fraction(0), Fraction(0))
        for _ in range(i):
            s = pool(s)
        s = u_net(s)
        for _ in range(i):
            s = up(s)
        if i < n - 1:
            s = up(pool(s))
        bl, br = max(bl, s[1]), max(br, s[2])
    return math.ceil(max(bl, br))


def halo(model: Mapping) -> int:
    """The certified halo rounded up to `multiple(model)` (see above)."""
    m = multiple(model)
    return -(-certified_halo(model) // m) * m
