"""Plain reference of the UNet denoiser with a KPN or residual head, in
float32, or with every convolution's operands rounded to float8 (the
control of a bfloat16 configuration).

Frozen from deepdenoiser_tpu_torch/models/{unet,layers,kpn,factory}.py at
commit 903e8b8 and written again without modules: the parameters are the
release file's flat Flax paths ("UNet_0/ConvStack_0/ConvBlock_0/Conv_0/
kernel", HWIO), read by numpy here, and every layer is a plain torch call.
What it computes, layer by layer:
  * a conv block: kxk conv + bias + leaky-ReLU (slope 0.2); stride 1 is
    SAME-padded, stride 2 pads as XLA does (low = total // 2);
  * the UNet: ConvStack_0, then per level DownSample (stride 2) and a
    ConvStack, then per level up nearest x2 + UpSample's conv and a
    ConvStack over [upsampled, skip], and the linear 1x1 Conv_0;
    space_to_depth / depth_to_space around it for a stride-2 stem;
  * the KPN head: per slot the logits (N,H,W,k²) RMS-normed times
    16*sigmoid(kernel_temp), softmaxed, and the k x k filter applied to the
    slot's 3 signal channels over a zero-padded plane, in float32;
  * the residual head: the output plus the signal channels.
`halo` is the certified one-sided receptive field, by the same interval
arithmetic as models/layers.RFState.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
F8_MAX = 448.0  # the largest float8 e4m3 value


def load_params(path) -> Dict[str, np.ndarray]:
    """The release npz as flat Flax paths (no 'params/' prefix), fp32."""
    with np.load(path) as z:
        return {k.split("/", 1)[1] if k.startswith("params/") else k: z[k].astype(np.float32)
                for k in z.files}


def to_device(flat: Mapping[str, np.ndarray], device, requires_grad: bool = False
              ) -> Dict[str, Tensor]:
    """Leaves as fp32 tensors on `device`; conv kernels HWIO as given."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=requires_grad)
            for k, v in flat.items()}


def round_f8(t: Tensor) -> Tensor:
    """t rounded to float8 e4m3 under one scale for the tensor (its absolute
    maximum maps to 448), back in float32; the gradient passes straight
    through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def _conv(p, name: str, x: Tensor, stride: int = 1, act: bool = True,
          f8: bool = False) -> Tensor:
    w = p[name + "/kernel"].permute(3, 2, 0, 1)
    b = p[name + "/bias"]
    if f8:
        x, w = round_f8(x), round_f8(w)
    k = w.shape[-1]
    if stride == 1:
        y = F.conv2d(x, w, b, padding=k // 2)
    else:
        pads = []
        for size in (x.shape[3], x.shape[2]):
            total = max((-(-size // stride) - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(x, pads), w, b, stride=stride)
    return F.leaky_relu(y, 0.2) if act else y


def _widths(model: Mapping):
    return [min(int(model["base_width"] * 2.0 ** level), 512) for level in range(model["depth"] + 1)]


def _space_to_depth(x: Tensor) -> Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _depth_to_space(x: Tensor) -> Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c // 4)


def unet(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """(N,H,W,Cin) fp32 -> the backbone's (N,H,W,Cout) fp32."""
    stem, depth, n_conv = model["stem_stride"], model["depth"], model["convs_per_level"]
    if stem == 2:
        x = _space_to_depth(x)
    x = x.permute(0, 3, 1, 2)

    def stack(i, x):
        for j in range(n_conv):
            x = _conv(p, f"UNet_0/ConvStack_{i}/ConvBlock_{j}/Conv_0", x, f8=f8)
        return x

    x = stack(0, x)
    skips = []
    for level in range(1, depth + 1):
        skips.append(x)
        x = _conv(p, f"UNet_0/DownSample_{level - 1}/ConvBlock_0/Conv_0", x, stride=2, f8=f8)
        x = stack(level, x)
    for i, level in enumerate(range(depth - 1, -1, -1)):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = _conv(p, f"UNet_0/UpSample_{i}/ConvBlock_0/Conv_0", x, f8=f8)
        x = stack(depth + 1 + i, torch.cat((x, skips[level]), dim=1))
    out = _conv(p, "UNet_0/Conv_0", x, act=False, f8=f8).permute(0, 2, 3, 1)
    return _depth_to_space(out) if stem == 2 else out


def signal(model: Mapping, x: Tensor) -> Tensor:
    """The noisy signal channels that the head filters or adds to: joint
    [9g .. 9g+5] for the four groups, else the leading channels."""
    if model["out_channels"] == 24:
        return torch.cat([x[..., 9 * g: 9 * g + 6] for g in range(4)], dim=-1)
    return x[..., : model["out_channels"]]


def filter_apply(noisy: Tensor, weights: Tensor, k: int) -> Tensor:
    """Per-pixel k x k filter of (N,H,W,C) by (N,H,W,k²) weights, zero pad,
    taps t = dy*k + dx."""
    n, h, w, c = noisy.shape
    p = k // 2
    padded = F.pad(noisy, (0, 0, p, p, p, p))
    out = torch.zeros_like(noisy)
    for dy in range(k):
        for dx in range(k):
            t = dy * k + dx
            out = out + padded[:, dy: dy + h, dx: dx + w, :] * weights[..., t: t + 1]
    return out


def kpn_head(p, feats: Tensor, sig: Tensor, model: Mapping) -> Tensor:
    k = model["kpn_size"]
    k2 = k * k
    taus = 16.0 * torch.sigmoid(p["KernelPredictionHead_0/kernel_temp"]) \
        if model["kpn_logit_norm"] else None
    outs = []
    for s in range(model["kpn_slots"]):
        logits = feats[..., s * k2: (s + 1) * k2]
        if taus is not None:
            rms = torch.sqrt(torch.mean(logits * logits, dim=-1, keepdim=True) + 1e-8)
            logits = logits / rms * taus[s]
        outs.append(filter_apply(sig[..., 3 * s: 3 * s + 3], torch.softmax(logits, dim=-1), k))
    return torch.cat(outs, dim=-1)


def network(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """The denoiser's forward: (N,H,W,Cin) fp32 encoded input -> (N,H,W,Cout)."""
    if model["backbone"] != "unet" or model["n_scales"] != 1:
        raise ValueError("this reference covers single-scale UNet models")
    out = unet(p, x, model, f8)
    if model["kernel_prediction"]:
        return kpn_head(p, out, signal(model, x), model)
    if model["predict_residual"]:
        return out + signal(model, x)
    return out


def halo(model: Mapping) -> int:
    """Certified one-sided receptive field (pixels) of the model."""
    a, bl, br = Fraction(1), Fraction(0), Fraction(0)

    def conv(state, k):
        a, bl, br = state
        d = Fraction(k - 1, 2) * a
        return a, bl + d, br + d

    def down(state, k):
        a, bl, br = state
        pad_low = (k - 2) // 2
        return a * 2, bl + pad_low * a, br + (k - 1 - pad_low) * a

    def up(state):
        a, bl, br = state
        return a / 2, bl + a / 2, br

    s = (a, bl, br)
    if model["stem_stride"] == 2:
        s = (s[0] * 2, s[1], s[2] + s[0])
    for _ in range(model["convs_per_level"]):
        s = conv(s, 3)
    for _ in range(model["depth"]):
        s = down(s, 3)
        for _ in range(model["convs_per_level"]):
            s = conv(s, 3)
    for _ in range(model["depth"]):
        s = conv(up(s), 3)
        for _ in range(model["convs_per_level"]):
            s = conv(s, 3)
    if model["stem_stride"] == 2:
        s = up(s)
    if model["kernel_prediction"]:
        s = conv(s, model["kpn_size"])
    return math.ceil(max(s[1], s[2]))
