"""Plain reference of the kernel-predicting convolutional network (KPCN) of
Bako et al., "Kernel-Predicting Convolutional Networks for Denoising Monte
Carlo Renderings", ACM TOG 36(4), SIGGRAPH 2017, sections 4-5, in float32,
or with every convolution's operands rounded to float8 (the control of a
bfloat16 configuration).

Written from the paper's description and the configuration's fields, without
modules: the parameters are the weights file's flat Flax paths
("KPCN_0/Conv_<i>/kernel", HWIO; "KPCN_0/Conv_<i>/bias"), read by numpy, and
every layer is a plain torch call. With D = depth convolutions and W =
base_width:
  * convs 0 .. D-2: 5x5, stride 1, SAME (zero) padding, W outputs, bias,
    ReLU; the first takes the encoded input's channels;
  * conv D-1: 5x5, linear, kpn_slots * kpn_size² outputs: the logits;
  * the head, per slot s: a plain softmax over the slot's kpn_size² logits
    (no norm, no temperature), and the kpn_size x kpn_size filter applied to
    the slot's 3 signal channels over a zero-padded plane, taps t = dy*k+dx.
Departures from the paper: one trunk emits both slots' kernels (the
paper trains a network per component, diffuse and specular); the slots
are a light group's direct and indirect light, each light group a batch
entry (the program's group mode); the input is the 14-channel group encode
(log-demodulated direct and indirect light, albedo, normal, depth,
alpha), without the paper's variance and gradient channels, which the
frames do not carry.
`halo` is the certified one-sided receptive field: 2 pixels a 5x5 conv and
kpn_size // 2 for the filter (28 at D = 9, k = 21); `multiple` is 1 (no
striding); `count_backbone` gives the D convolutions' rows of the frozen
counter (counts._Net.conv_block, the last without activation; no cast row);
`param_shapes` the parameters a seeded weights file holds.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.unet import (conv_shapes, kpn_head, load_params, round_f8, signal,
                                       to_device)

__all__ = ["load_params", "to_device", "network", "halo", "multiple", "count_backbone",
           "param_shapes"]

Tensor = torch.Tensor
KERNEL = 5


def _convs(model: Mapping, cin: int, cout: int) -> Dict[str, Tuple[int, int, int]]:
    """{conv path: (k, c_in, c_out)} of the trunk, in order."""
    depth = model["depth"]
    widths = [cin] + [model["base_width"]] * (depth - 1) + [cout]
    return {f"KPCN_0/Conv_{i}": (KERNEL, a, b) for i, (a, b) in enumerate(zip(widths, widths[1:]))}


def _logits_channels(model: Mapping) -> int:
    return model["kpn_slots"] * model["kpn_size"] ** 2


def _check(model: Mapping) -> None:
    if (model["backbone"] != "kpcn" or model["n_scales"] != 1 or not model["kernel_prediction"]
            or model["kpn_logit_norm"] or model["act"] != "relu"):
        raise ValueError("this reference covers the single-scale KPCN with ReLU and a plain "
                         "softmax KPN head")


def network(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """The denoiser's forward: (N,H,W,Cin) fp32 encoded input -> the
    filtered (N,H,W,3*kpn_slots) signal."""
    _check(model)
    y = x.permute(0, 3, 1, 2)
    convs = list(_convs(model, model["in_channels"], _logits_channels(model)))
    for i, name in enumerate(convs):
        w = p[name + "/kernel"].permute(3, 2, 0, 1)
        if f8:
            y, w = round_f8(y), round_f8(w)
        y = F.conv2d(y, w, p[name + "/bias"], padding=KERNEL // 2)
        if i < len(convs) - 1:
            y = F.relu(y)
    return kpn_head(p, y.permute(0, 2, 3, 1), signal(model, x), model)


def halo(model: Mapping) -> int:
    """Certified one-sided receptive field (pixels) of the model."""
    return model["depth"] * (KERNEL // 2) + model["kpn_size"] // 2


def multiple(model: Mapping) -> int:
    """No striding: the plane may have any size."""
    return 1


def count_backbone(net, n: int, h: int, w: int, cin: int, cout: int, prefix: str = "") -> None:
    """The trunk's rows: one conv block a conv, the last without activation."""
    convs = _convs(net.m, cin, cout)
    for i, (name, (k, a, b)) in enumerate(convs.items()):
        net.conv_block(prefix + name, n, h, w, a, b, k, act=i < len(convs) - 1)


def param_shapes(model: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Flat Flax path -> shape of every parameter, kernels HWIO."""
    _check(model)
    return conv_shapes(_convs(model, model["in_channels"], _logits_channels(model)))
