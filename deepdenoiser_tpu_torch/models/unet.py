"""U-Net backbone (upstream: TensorFlow/UNet.py — SURVEY.md C11).

The port of deepdenoiser_tpu/models/unet.py: encoder/decoder with skip
connections, stride-2 conv down, resize-conv up, a linear 1x1 head whose
output is cast to fp32. Takes and returns NHWC; inside, the activations
live in channels_last memory, so the NHWC input and output are views and
the convs run on cuDNN's NHWC path. With stem_stride=2 the input goes
through space_to_depth first, the whole network runs at half resolution,
the head emits 4x the output channels and depth_to_space restores the
frame. With `remat` each conv stack runs under torch.utils.checkpoint
when gradients are on (its activations are recomputed in the backward
pass, as jax.checkpoint does in the JAX UNet); the parameter names do not
change.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from deepdenoiser_tpu_torch.models import layers
from deepdenoiser_tpu_torch.models.layers import RFState
from deepdenoiser_tpu_torch.ops import bias_act

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    base_width: int = 64
    depth: int = 3  # number of downsamplings
    convs_per_level: int = 2
    kernel: int = 3
    act: str = "relu"
    width_growth: float = 2.0  # channel multiplier per level
    max_width: int = 512
    stem_stride: int = 1  # 2 = space-to-depth stem (half-resolution network)
    remat: bool = False  # recompute each conv stack's activations in the backward pass

    def width(self, level: int) -> int:
        return min(int(self.base_width * self.width_growth**level), self.max_width)

    def rf_state(self, s: RFState = RFState()) -> RFState:
        """Per-side RF bounds of the deepest encoder→bottleneck→decoder path."""
        if self.stem_stride == 2:
            s = s.pool(2)
        for _ in range(self.convs_per_level):
            s = s.conv(self.kernel)
        for _ in range(self.depth):
            s = s.down_conv(self.kernel)
            for _ in range(self.convs_per_level):
                s = s.conv(self.kernel)
        for _ in range(self.depth):
            s = s.upsample(2).conv(self.kernel)
            for _ in range(self.convs_per_level):
                s = s.conv(self.kernel)
        if self.stem_stride == 2:
            s = s.upsample(2)
        return s

    @property
    def spatial_multiple(self) -> int:
        return 2**self.depth * self.stem_stride


class UNet(nn.Module):
    """in_channels-in → out_channels-out U-Net; the output layer is linear.
    Submodules carry the Flax scope names of the JAX UNet."""

    def __init__(self, spec: UNetSpec, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spec.stem_stride not in (1, 2):
            raise ValueError(f"stem_stride must be 1 or 2, got {spec.stem_stride}")
        self.spec, self.dtype = spec, dtype
        kw = dict(kernel=spec.kernel, act=spec.act, dtype=dtype)
        n = spec.convs_per_level
        widths = [spec.width(level) for level in range(spec.depth + 1)]
        stacks = [layers.ConvStack(in_channels * spec.stem_stride**2, widths[0], n, **kw)]
        for level in range(1, spec.depth + 1):
            self.add_module(
                f"DownSample_{level - 1}",
                layers.DownSample(widths[level - 1], widths[level], **kw),
            )
            stacks.append(layers.ConvStack(widths[level], widths[level], n, **kw))
        prev = widths[spec.depth]
        for i, level in enumerate(range(spec.depth - 1, -1, -1)):
            self.add_module(
                f"UpSample_{i}", layers.UpSample(prev, widths[level], **kw)
            )
            # first conv sees [upsampled, skip] channels
            stacks.append(layers.ConvStack(2 * widths[level], widths[level], n, **kw))
            prev = widths[level]
        for i, s in enumerate(stacks):
            self.add_module(f"ConvStack_{i}", s)
        self.Conv_0 = nn.Conv2d(prev, out_channels * spec.stem_stride**2, 1)

    def _stack(self, i: int, x) -> Tensor:
        stack = getattr(self, f"ConvStack_{i}")
        if self.spec.remat and torch.is_grad_enabled():
            return checkpoint.checkpoint(stack, x, use_reentrant=False)
        return stack(x)

    def forward(self, x: Tensor) -> Tensor:
        spec = self.spec
        n, h, w, _ = x.shape
        m = spec.spatial_multiple
        if h % m or w % m:
            raise ValueError(f"UNet input {h}x{w} must be divisible by {m}; pad first")
        x = x.to(self.dtype)
        if spec.stem_stride == 2:
            x = layers.space_to_depth(x, 2)
        # NHWC -> NCHW view with channels_last strides (no copy when dense)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self._stack(0, x)
        skips = []
        for level in range(1, spec.depth + 1):
            skips.append(x)
            x = getattr(self, f"DownSample_{level - 1}")(x)
            x = self._stack(level, x)
        for i, level in enumerate(range(spec.depth - 1, -1, -1)):
            x = getattr(self, f"UpSample_{i}")(x)
            x = self._stack(spec.depth + 1 + i, (x, skips[level]))
        out = F.conv2d(x, self.Conv_0.weight.to(self.dtype))
        out = bias_act.bias_act(out, self.Conv_0.bias, "none")
        out = out.permute(0, 2, 3, 1)
        if spec.stem_stride == 2:
            out = layers.depth_to_space(out, 2)
        return out.float()
