"""FC-DenseNet "Tiramisu" backbone (upstream: TensorFlow/Tiramisu.py —
SURVEY.md C12).

The port of deepdenoiser_tpu/models/tiramisu.py: dense blocks with
transition down (1x1 conv to half the channels + 2x2 average pool) and
transition up (resize-conv), a linear 1x1 head whose output is cast to
fp32. Takes and returns NHWC; inside, NCHW tensors in channels_last memory
as in the UNet. With stem_stride=2 the dense stack runs at half
resolution between space_to_depth and depth_to_space.

Dense connectivity is real channel concatenation (`torch.cat`) here. The
JAX spec's `concat_free` and `dense_base_split` choose between lowerings
of the same function with the same parameter tree; the fields are kept so
a config loads in both packages, and both are this one concat path.

Submodules carry the Flax scope names, which count per class in call
order: ConvBlock_0 is the stem, ConvBlock_1..depth the transition-down
convs, the following ConvBlocks the up-path 1x1 compressions (present only
where the joined width exceeds `up_compress`), DenseBlock_0 the entry
block, DenseBlock_1..depth the down path, the rest the up path,
UpSample_0..depth-1, and Conv_0 the head. A release file therefore maps
onto the state_dict by path (weights_io.py).

Spans (tracing.py), inside the model's `backbone` span: `dense` around
each dense block and its join [x, block(x)], `transition` around each
transition down (1x1 conv and average pool) and each transition up (the
resize-conv and the [up, skip] join, or its 1x1 compression). The
module-level counts `concats` and `concat_bytes` take every multi-input
channel concatenation the backbone launches (a dense layer's [x, f1..],
a block's [f1..fn], the joins [x, block] and [up, skip]) and the bytes it
writes, from the shapes on the host; a dense block's first layer reads x
alone and is not counted. `reset_concats()` zeroes them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepdenoiser_tpu_torch import tracing
from deepdenoiser_tpu_torch.models import layers
from deepdenoiser_tpu_torch.models.layers import RFState
from deepdenoiser_tpu_torch.ops import bias_act

Tensor = torch.Tensor

# multi-input concatenations launched since the last reset, and the bytes
# they wrote (plain counts; added where each tuple is built)
concats = 0
concat_bytes = 0


def reset_concats() -> None:
    global concats, concat_bytes
    concats = concat_bytes = 0


def _counted(parts: Sequence[Tensor]) -> Sequence[Tensor]:
    """`parts`, after counting their channel concatenation (more than one
    part) by the shapes alone: no device work."""
    global concats, concat_bytes
    if len(parts) > 1:
        n, _, h, w = parts[0].shape
        concats += 1
        concat_bytes += n * h * w * sum(p.shape[1] for p in parts) * parts[0].element_size()
    return parts


@dataclasses.dataclass(frozen=True)
class TiramisuSpec:
    growth_rate: int = 16
    layers_per_block: int = 4
    depth: int = 3  # number of transition-downs
    stem_width: int = 48
    kernel: int = 3
    act: str = "relu"
    stem_stride: int = 1  # 2 = space-to-depth stem (half-resolution dense stack)
    # >0 bounds the up-path width: after the [upsampled, skip] join a 1x1
    # conv compresses to this many channels before the dense block
    up_compress: int = 0
    # lowering switches of the JAX package (identical function and
    # parameter tree); read by nothing here
    concat_free: bool = False
    dense_base_split: bool = False
    # >0: dense-layer count of the two full-resolution blocks only (the
    # entry block and the last up block); the coarser blocks keep
    # layers_per_block
    layers_top: int = 0

    @property
    def _layers_top(self) -> int:
        return self.layers_top or self.layers_per_block

    def rf_state(self, s: RFState = RFState()) -> RFState:
        k, n = self.kernel, self.layers_per_block
        if self.stem_stride == 2:
            s = s.pool(2)  # space-to-depth window
        s = s.conv(k)  # stem
        for _ in range(self._layers_top):  # entry dense block (full res)
            s = s.conv(k)
        for _ in range(self.depth):  # down path
            s = s.pool(2)  # transition down (the 1x1 conv adds nothing)
            for _ in range(n):
                s = s.conv(k)
        for i in range(self.depth):  # up path (coarse -> fine)
            s = s.upsample(2).conv(k)  # transition-up conv
            n_here = self._layers_top if i == self.depth - 1 else n
            for _ in range(n_here):
                s = s.conv(k)
        if self.stem_stride == 2:
            s = s.upsample(2)  # depth-to-space
        return s

    def receptive_field(self) -> int:
        return self.rf_state().r

    @property
    def spatial_multiple(self) -> int:
        return 2**self.depth * self.stem_stride


class DenseBlock(nn.Module):
    """n_layers convs, layer i reading [x, f_1, .., f_{i-1}]; returns the
    new feature maps concatenated (not the input)."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int, kernel: int,
                 act: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(
                f"ConvBlock_{i}",
                layers.ConvBlock(in_channels + i * growth_rate, growth_rate, kernel,
                                 act=act, dtype=dtype),
            )

    def forward(self, x: Tensor) -> Tensor:
        feats: List[Tensor] = []
        for i in range(self.n_layers):
            feats.append(getattr(self, f"ConvBlock_{i}")(_counted((x, *feats))))
        return feats[0] if len(feats) == 1 else torch.cat(_counted(feats), dim=1)


class Tiramisu(nn.Module):
    """in_channels-in → out_channels-out FC-DenseNet; the head is linear."""

    def __init__(self, spec: TiramisuSpec, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spec.stem_stride not in (1, 2):
            raise ValueError(f"stem_stride must be 1 or 2, got {spec.stem_stride}")
        self.spec, self.dtype = spec, dtype
        kw = dict(act=spec.act, dtype=dtype)
        g, n = spec.growth_rate, spec.layers_per_block
        conv_blocks: List[nn.Module] = []
        dense_blocks: List[nn.Module] = []

        def dense(channels: int, n_layers: int) -> int:
            """Register the next dense block; the width after [x, feats]."""
            dense_blocks.append(DenseBlock(channels, g, n_layers, spec.kernel, **kw))
            return channels + g * n_layers

        conv_blocks.append(layers.ConvBlock(in_channels * spec.stem_stride**2,
                                            spec.stem_width, spec.kernel, **kw))
        c = dense(spec.stem_width, spec._layers_top)
        skips = []
        for _ in range(spec.depth):
            skips.append(c)
            conv_blocks.append(layers.ConvBlock(c, c // 2, 1, **kw))  # transition down
            c = dense(c // 2, n)
        self.compress: List[int] = []  # ConvBlock index of each level's 1x1, or -1
        for level, skip in enumerate(reversed(skips)):
            up = max(g * n, skip // 2)
            self.add_module(f"UpSample_{level}", layers.UpSample(c, up, spec.kernel, **kw))
            c = up + skip
            if spec.up_compress > 0 and c > spec.up_compress:
                self.compress.append(len(conv_blocks))
                conv_blocks.append(layers.ConvBlock(c, spec.up_compress, 1, **kw))
                c = spec.up_compress
            else:
                self.compress.append(-1)
            c = dense(c, spec._layers_top if level == spec.depth - 1 else n)
        for i, m in enumerate(conv_blocks):
            self.add_module(f"ConvBlock_{i}", m)
        for i, m in enumerate(dense_blocks):
            self.add_module(f"DenseBlock_{i}", m)
        self.Conv_0 = nn.Conv2d(c, out_channels * spec.stem_stride**2, 1)

    def forward(self, x: Tensor) -> Tensor:
        spec = self.spec
        n, h, w, _ = x.shape
        m = spec.spatial_multiple
        if h % m or w % m:
            raise ValueError(f"Tiramisu input {h}x{w} must be divisible by {m}; pad tiles first")
        x = x.to(self.dtype)
        if spec.stem_stride == 2:
            x = layers.space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        stem = self.ConvBlock_0(x)
        with tracing.span("dense"):
            x = torch.cat(_counted((stem, self.DenseBlock_0(stem))), dim=1)
        skips = []
        for level in range(1, spec.depth + 1):
            skips.append(x)
            with tracing.span("transition"):
                x = F.avg_pool2d(getattr(self, f"ConvBlock_{level}")(x), 2)
            with tracing.span("dense"):
                x = torch.cat(_counted((x, getattr(self, f"DenseBlock_{level}")(x))), dim=1)
        for level, skip in enumerate(reversed(skips)):
            with tracing.span("transition"):
                # join order [up, skip]
                x = _counted((getattr(self, f"UpSample_{level}")(x), skip))
                if self.compress[level] >= 0:
                    x = getattr(self, f"ConvBlock_{self.compress[level]}")(x)
                else:
                    x = torch.cat(x, dim=1)
            with tracing.span("dense"):
                block = getattr(self, f"DenseBlock_{spec.depth + 1 + level}")
                x = torch.cat(_counted((x, block(x))), dim=1)
        out = F.conv2d(x, self.Conv_0.weight.to(self.dtype))
        out = bias_act.bias_act(out, self.Conv_0.bias, "none")
        out = out.permute(0, 2, 3, 1)
        if spec.stem_stride == 2:
            out = layers.depth_to_space(out, 2)
        return out.float()
