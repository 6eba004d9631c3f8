"""The kernel-predicting convolutional network (KPCN) of Bako et al.,
"Kernel-Predicting Convolutional Networks for Denoising Monte Carlo
Renderings", ACM TOG 36(4), SIGGRAPH 2017, sections 4-5: a plain stack of
full-resolution k x k convolutions without striding, the hidden ones with
ReLU and the last one linear, whose outputs are the per-pixel filter logits
of the KPN head (models/kpn.py) after it.

It has no counterpart in the JAX package; it is expressed in the fields
ModelConfig already has: `base_width` is the hidden width (100 in the
paper), `depth` the number of convolutions (9), `act` the hidden
activation; the 5x5 kernel is fixed here, as the UNet fixes its 3x3. The
last conv emits kpn_slots * kpn_size² logits: one trunk for every slot,
where the paper trains a network per component (diffuse, specular).

Each conv is a layers.ConvBlock (cuDNN conv in the compute dtype, channels-
last, then ops/bias_act's bias and activation in one pass). The parameters
sit at flat paths KPCN_0/Conv_<i>/{kernel,bias} at the published widths,
so a release-format file loads by path: each block's conv is registered
here under Conv_<i>, and the blocks themselves are kept in a plain list.

The convs run at widths padded with zeros: the input's 14 channels and the
hidden 100 to a multiple of CHANNEL_MULTIPLE (32, so 32 and 128), the 882
logits to a multiple of LOGIT_MULTIPLE (8, so 888). These are what
cuDNN's bf16 NHWC 5x5 convs on the H100 run fastest at the KPCN's plane:
at 100 channels they take a slow kernel behind a padding pass of their
own (35.0 ms a hidden conv; 10.4 at 128, 1.64x the FLOPs), the first conv
takes 8.9 ms from 14 channels and 2.8 from 32, and the logits conv from
128 channels 97.1 ms at 882 outputs, 74.1 at 888, 92.1 at 896. The
padded weights and biases are zero (the padded channels stay zero through bias and ReLU
and add exact zeros to every sum), made once from the parameters and kept
while they do not change (without grad), so the function is the published
network's. Takes NHWC fp32, returns the NHWC logits in the compute dtype,
a view of the first out_channels of the padded output (no fp32 copy: the
head reads bf16 logits in place, through the view's pixel stride).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepdenoiser_tpu_torch.models import layers
from deepdenoiser_tpu_torch.models.layers import RFState

Tensor = torch.Tensor

CHANNEL_MULTIPLE = 32  # the input and hidden widths the convs run at
LOGIT_MULTIPLE = 8  # the logits' width the last conv runs at


def padded(channels: int, multiple: int) -> int:
    return -(-channels // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class KPCNSpec:
    width: int = 100  # hidden width (ModelConfig.base_width)
    n_convs: int = 9  # convolutions, the last one linear (ModelConfig.depth)
    kernel: int = 5
    act: str = "relu"

    def rf_state(self, s: RFState = RFState()) -> RFState:
        for _ in range(self.n_convs):
            s = s.conv(self.kernel)
        return s

    @property
    def spatial_multiple(self) -> int:
        return 1  # no striding: any plane size


class KPCN(nn.Module):
    """in_channels -> out_channels through `n_convs` k x k convs of `width`
    outputs (the last of out_channels, linear)."""

    def __init__(self, spec: KPCNSpec, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spec.n_convs < 1:
            raise ValueError(f"KPCN needs at least one conv, got {spec.n_convs}")
        self.spec, self.dtype = spec, dtype
        self.widths = [in_channels] + [spec.width] * (spec.n_convs - 1) + [out_channels]
        self.run_widths = [padded(c, CHANNEL_MULTIPLE) for c in self.widths[:-1]] + [
            padded(out_channels, LOGIT_MULTIPLE)]
        self.blocks = [
            layers.ConvBlock(a, b, spec.kernel, act=spec.act if i < spec.n_convs - 1 else "none",
                             dtype=dtype)
            for i, (a, b) in enumerate(zip(self.widths, self.widths[1:]))
        ]
        for i, block in enumerate(self.blocks):
            self.add_module(f"Conv_{i}", block.Conv_0)
        self._padded: Optional[tuple] = None  # (key, [(weight, bias)])

    @property
    def head(self) -> nn.Conv2d:
        """The last (linear) conv."""
        return getattr(self, f"Conv_{self.spec.n_convs - 1}")

    def _pad_params(self) -> List[Tuple[Tensor, Tensor]]:
        """Each conv's weight, in the compute dtype, and bias, zero-padded to
        the run widths. Without grad they are kept and made anew only when
        a parameter changes (its version, storage, device or dtype)."""
        convs = [block.Conv_0 for block in self.blocks]

        def make():
            out = []
            for conv, ci, co in zip(convs, self.run_widths, self.run_widths[1:]):
                w, b = conv.weight.to(self.dtype), conv.bias
                out.append((F.pad(w, (0, 0, 0, 0, 0, ci - w.shape[1], 0, co - w.shape[0])),
                            F.pad(b, (0, co - b.shape[0]))))
            return out

        params = [p for conv in convs for p in (conv.weight, conv.bias)]
        if torch.is_grad_enabled() or any(p.is_inference() for p in params):
            return make()
        key = (self.dtype, *((p.data_ptr(), p._version, p.device, p.dtype) for p in params))
        if self._padded is None or self._padded[0] != key:
            self._padded = (key, make())
        return self._padded[1]

    def forward(self, x: Tensor) -> Tensor:
        n, h, w, c = x.shape
        if self.run_widths[0] == c:
            x = x.to(self.dtype)
        else:
            x, src = x.new_zeros((n, h, w, self.run_widths[0]), dtype=self.dtype), x
            x[..., :c] = src
        # NHWC -> NCHW view with channels_last strides (no copy when dense)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for block, (weight, bias) in zip(self.blocks, self._pad_params()):
            x = block(x, weight, bias)
        return x.permute(0, 2, 3, 1)[..., : self.widths[-1]]
