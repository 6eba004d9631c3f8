"""Plain reference of the FC-DenseNet ("Tiramisu") denoiser with its residual
head, in float32, or with every convolution's operands rounded to float8
(the control of a bfloat16 configuration).

Written from deepdenoiser_tpu_torch/models/tiramisu.py at commit 1672e99
without modules: the parameters are the release file's flat Flax paths
("Tiramisu_0/DenseBlock_1/ConvBlock_2/Conv_0/kernel", HWIO), read by numpy,
and every layer is a plain torch call. The conv block, the float8 rounding
and the signal gather are reference/unet.py's. With g the growth rate, n
the layers of a block (n_top in the two full-resolution blocks), cat the
channel concatenation and conv_k a k x k SAME conv + bias + leaky-ReLU
(slope 0.2):
  * stem: x0 = conv_3(x) to 48 channels;
  * dense block B(x): f_i = conv_3(cat[x, f_1 .. f_(i-1)]) to g channels,
    i = 1..n; B(x) = cat[f_1 .. f_n] (f_1 when n = 1); the path goes on
    with cat[x, B(x)], c + n*g channels, up and down alike;
  * transition down, at each of `depth` levels: the skip is kept, then
    avg_pool_2x2(conv_1(x) to c // 2 channels), then a dense block;
  * transition up, coarse to fine: u = conv_3(nearest_x2(x)) to
    max(g*n, skip // 2) channels, the join j = cat[u, skip], then
    conv_1(j) to `up_compress` channels where up_compress > 0 and j is
    wider (otherwise j itself), then a dense block;
  * head: a linear 1x1 conv to 24 channels, plus the 24 signal channels.
Departures from Jegou et al. (CVPRW 2017): no batch norm and no dropout
(conv, bias, activation, in that order); leaky-ReLU, not ReLU; the
transition down halves the channels and average-pools where the paper
keeps them and max-pools; the transition up is a resize-conv of the whole
path where the paper transposes a conv of the last block's new maps
alone; the up path keeps [x, B(x)] where the paper keeps B(x); the deepest
down block stands for the bottleneck block; the 1x1 compression of the
join is not the paper's; a linear residual head in place of the softmax
classifier.
`halo` is the certified one-sided receptive field, by the same interval
arithmetic as TiramisuSpec.rf_state; `multiple` the size the plane
divides, 2**depth * stem_stride; `count_backbone` its rows of the frozen
counter (counts._Net.tiramisu); `param_shapes` the parameters of the
release format, in the order `tiramisu` reads them.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.unet import _conv, conv_shapes, load_params, signal, to_device

__all__ = ["load_params", "to_device", "network", "halo", "multiple", "count_backbone",
           "param_shapes"]

STEM_WIDTH = 48

Tensor = torch.Tensor


def _top(model: Mapping) -> int:
    return model["layers_top"] or model["layers_per_block"]


def tiramisu(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """(N,H,W,Cin) fp32 -> the backbone's (N,H,W,Cout) fp32."""
    g, n, depth = model["growth_rate"], model["layers_per_block"], model["depth"]
    blocks = iter(range(2 * depth + 1))
    convs = iter(range(1, 2 * depth + 1))  # ConvBlock_0 is the stem

    def dense(x, n_layers):
        b = f"Tiramisu_0/DenseBlock_{next(blocks)}"
        feats = []
        for i in range(n_layers):
            feats.append(_conv(p, f"{b}/ConvBlock_{i}/Conv_0", torch.cat([x] + feats, dim=1), f8=f8))
        return torch.cat([x] + feats, dim=1)

    x = _conv(p, "Tiramisu_0/ConvBlock_0/Conv_0", x.permute(0, 3, 1, 2), f8=f8)
    x = dense(x, _top(model))
    skips = []
    for _ in range(depth):
        skips.append(x)
        x = F.avg_pool2d(_conv(p, f"Tiramisu_0/ConvBlock_{next(convs)}/Conv_0", x, f8=f8), 2)
        x = dense(x, n)
    for level, skip in enumerate(reversed(skips)):
        up = _conv(p, f"Tiramisu_0/UpSample_{level}/ConvBlock_0/Conv_0",
                   F.interpolate(x, scale_factor=2, mode="nearest"), f8=f8)
        x = torch.cat((up, skip), dim=1)
        if 0 < model["up_compress"] < x.shape[1]:
            x = _conv(p, f"Tiramisu_0/ConvBlock_{next(convs)}/Conv_0", x, f8=f8)
        x = dense(x, _top(model) if level == depth - 1 else n)
    return _conv(p, "Tiramisu_0/Conv_0", x, act=False, f8=f8).permute(0, 2, 3, 1)


def network(p, x: Tensor, model: Mapping, f8: bool = False) -> Tensor:
    """The denoiser's forward: (N,H,W,Cin) fp32 encoded input -> (N,H,W,Cout)."""
    if (model["backbone"] != "tiramisu" or model["n_scales"] != 1 or model["stem_stride"] != 1
            or model["kernel_prediction"] or not model["predict_residual"]
            or model["act"] != "leaky_relu"):
        raise ValueError("this reference covers single-scale residual tiramisu models "
                         "with a stride-1 stem and leaky-ReLU")
    return tiramisu(p, x, model, f8) + signal(model, x)


def halo(model: Mapping) -> int:
    """Certified one-sided receptive field (pixels) of the model."""
    a, bl, br = Fraction(1), Fraction(0), Fraction(0)

    def conv(n_convs):
        nonlocal bl, br
        bl, br = bl + n_convs * a, br + n_convs * a  # 3x3 SAME: (3 - 1) / 2 a side

    conv(1 + _top(model))  # stem, entry block
    for _ in range(model["depth"]):
        a, br = 2 * a, br + a  # 2x2 average pool
        conv(model["layers_per_block"])
    for level in range(model["depth"]):
        a = a / 2  # nearest x2
        bl += a
        conv(1 + (_top(model) if level == model["depth"] - 1 else model["layers_per_block"]))
    return math.ceil(max(bl, br))


def multiple(model: Mapping) -> int:
    """The size the network's plane divides: 2**depth * stem_stride."""
    return 2 ** model["depth"] * model["stem_stride"]


def count_backbone(net, n: int, h: int, w: int, cin: int, cout: int, prefix: str = "") -> None:
    """The FC-DenseNet's rows (counts._Net.tiramisu) over an (n, h, w, cin)
    input."""
    net.tiramisu(n, h, w, cin, cout, prefix)


def param_shapes(model: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Flat Flax path -> shape of every parameter of the FC-DenseNet, kernels
    HWIO: the convs `tiramisu` reads, with the widths it reads them at."""
    g, n, depth = model["growth_rate"], model["layers_per_block"], model["depth"]
    convs: Dict[str, Tuple[int, int, int]] = {}
    blocks = iter(range(2 * depth + 1))
    transitions = iter(range(1, 2 * depth + 1))

    def dense(c, n_layers):
        b = f"Tiramisu_0/DenseBlock_{next(blocks)}"
        for i in range(n_layers):
            convs[f"{b}/ConvBlock_{i}/Conv_0"] = (3, c + i * g, g)
        return c + n_layers * g

    convs["Tiramisu_0/ConvBlock_0/Conv_0"] = (3, model["in_channels"], STEM_WIDTH)
    c = dense(STEM_WIDTH, _top(model))
    skips = []
    for _ in range(depth):
        skips.append(c)
        convs[f"Tiramisu_0/ConvBlock_{next(transitions)}/Conv_0"] = (1, c, c // 2)
        c = dense(c // 2, n)
    for level, skip in enumerate(reversed(skips)):
        up = max(g * n, skip // 2)
        convs[f"Tiramisu_0/UpSample_{level}/ConvBlock_0/Conv_0"] = (3, c, up)
        c = up + skip
        if 0 < model["up_compress"] < c:
            convs[f"Tiramisu_0/ConvBlock_{next(transitions)}/Conv_0"] = (1, c, model["up_compress"])
            c = model["up_compress"]
        c = dense(c, _top(model) if level == depth - 1 else n)
    convs["Tiramisu_0/Conv_0"] = (1, c, model["out_channels"])
    return conv_shapes(convs)
