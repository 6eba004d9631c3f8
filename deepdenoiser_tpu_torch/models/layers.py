"""Conv building blocks and receptive-field algebra (upstream:
TensorFlow/Conv2dUtilities.py — SURVEY.md C10).

The port of deepdenoiser_tpu/models/layers.py. Public tensors are NCHW
inside the network (the UNet takes and returns NHWC at its edge, and keeps
its activations in channels_last memory, which is the same bytes). Every
conv computes in the model's compute dtype with the fp32 parameters cast
to it, bias and activation included, as flax `nn.Conv(dtype=...)` does.

Three details carry the JAX semantics across:
  * leaky-ReLU has slope 0.2, not PyTorch's default 0.01;
  * stride-2 SAME padding follows XLA: the total pad is split low = total
    // 2, high = the rest, so an even input pads (0, 1), not (1, 1);
  * the decoder's concat-free join in JAX splits the first conv's input
    channels as [upsampled, skip]; here the two are concatenated in that
    order and one conv runs.
The JAX UpSample is a sub-pixel conv at low resolution; nearest-up(2)
then a 3x3 SAME conv with the same kernel is the same function, and that
is the form used here. nearest_upsample and avg_downsample are the NHWC
helpers of the multi-scale pyramid.

space_to_depth / depth_to_space are NHWC like the JAX functions and keep
their channel order, (dy*f + dx)*C + c, which is not F.pixel_unshuffle's
(c*f*f + dy*f + dx): the release stem and head kernels of the stride-2
models assume it. They are a reshape and a permute; the JAX package's
one-hot-conv form is a TPU layout device and is not carried over.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "silu": F.silu,
    "none": lambda x: x,
}


def activation(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise KeyError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}") from e


@dataclasses.dataclass(frozen=True)
class RFState:
    """Certified per-side receptive-field bounds along one spatial axis:
    an output pixel p depends on input pixels within [a*p - bl, a*p + br].
    The same interval arithmetic as the JAX package (see its RFState for
    the derivation of each op's window); Fractions keep it exact."""

    a: Fraction = Fraction(1)
    bl: Fraction = Fraction(0)
    br: Fraction = Fraction(0)

    def conv(self, kernel: int, stride: int = 1) -> "RFState":
        if stride == 1:
            assert kernel % 2 == 1, "stride-1 convs assumed odd (SAME centered)"
            d = Fraction(kernel - 1, 2) * self.a
            return RFState(self.a, self.bl + d, self.br + d)
        if stride == 2:
            return self.down_conv(kernel)
        raise NotImplementedError(f"stride {stride}")

    def down_conv(self, kernel: int) -> "RFState":
        # XLA SAME, stride 2, even input: pad_low = (k-2)//2
        pad_low = (kernel - 2) // 2
        lo = -pad_low
        hi = kernel - 1 - pad_low
        return RFState(self.a * 2, self.bl - lo * self.a, self.br + hi * self.a)

    def pool(self, kernel: int, stride: Optional[int] = None) -> "RFState":
        s = stride if stride is not None else kernel
        assert s == kernel == 2, "only 2x2/2 pooling used"
        return RFState(self.a * 2, self.bl, self.br + self.a)

    def upsample(self, factor: int) -> "RFState":
        assert factor == 2, "only 2x nearest upsampling used"
        a2 = self.a / 2
        return RFState(a2, self.bl + a2, self.br)

    def max_with(self, other: "RFState") -> "RFState":
        return RFState(self.a, max(self.bl, other.bl), max(self.br, other.br))

    @property
    def r(self) -> int:
        """Total receptive-field span in input pixels."""
        return math.ceil(self.bl + self.br) + 1

    @property
    def halo(self) -> int:
        """Certified one-sided halo (input pixels) for seam-free tiling."""
        return math.ceil(max(self.bl, self.br))


def lecun_normal_(weight: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
    """Flax's default conv kernel init (`nn.initializers.lecun_normal()`:
    variance_scaling(1, 'fan_in', 'truncated_normal')) on an OIHW weight:
    a normal truncated at two standard deviations, scaled so the variance
    is 1/fan_in, fan_in = in_channels * kh * kw. In place."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the std of N(0,1) cut at +-2
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding for one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """kxk conv + bias + activation. `x` may be a sequence of tensors,
    taken as their channel concatenation in that order."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel: int = 3,
        stride: int = 1,
        act: str = "relu",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.act = activation(act)
        # Flax scope name, so release weights map by path (weights_io.py).
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel)

    def forward(self, x: Union[Tensor, Sequence[Tensor]]) -> Tensor:
        if not isinstance(x, Tensor):
            x = torch.cat(tuple(x), dim=1)
        x = x.to(self.dtype)
        k, s = self.kernel, self.stride
        if s == 1 and k % 2 == 1:
            padding = k // 2
        else:
            (t, b), (l, r) = (_same_pads(x.shape[2], k, s), _same_pads(x.shape[3], k, s))
            x = F.pad(x, (l, r, t, b)).contiguous(memory_format=torch.channels_last)
            padding = 0
        y = F.conv2d(
            x,
            self.Conv_0.weight.to(self.dtype),
            self.Conv_0.bias.to(self.dtype),
            stride=s,
            padding=padding,
        )
        return self.act(y)


class ConvStack(nn.Module):
    """n_convs back-to-back ConvBlocks at fixed width; the first accepts a
    sequence input ((upsampled, skip) in the decoder)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        n_convs: int = 2,
        kernel: int = 3,
        act: str = "relu",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(
                f"ConvBlock_{i}",
                ConvBlock(in_channels if i == 0 else features, features, kernel,
                          act=act, dtype=dtype),
            )

    def forward(self, x) -> Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"ConvBlock_{i}")(x)
        return x


class DownSample(nn.Module):
    """Stride-2 conv downsample (XLA SAME padding)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 act: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_channels, features, kernel, stride=2,
                                     act=act, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.ConvBlock_0(x)


class UpSample(nn.Module):
    """Nearest-resize x2 + kxk conv (the function the JAX sub-pixel conv
    computes)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 act: str = "relu", factor: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.factor = factor
        self.ConvBlock_0 = ConvBlock(in_channels, features, kernel, act=act,
                                     dtype=dtype)

    def forward(self, x: Union[Tensor, Sequence[Tensor]]) -> Tensor:
        if not isinstance(x, Tensor):
            x = torch.cat(tuple(x), dim=1)
        x = F.interpolate(x.to(self.ConvBlock_0.dtype), scale_factor=self.factor,
                          mode="nearest")
        return self.ConvBlock_0(x)


def nearest_upsample(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsample, NHWC: every pixel repeated factor x
    factor times."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def avg_downsample(x: Tensor, factor: int = 2) -> Tensor:
    """Average-pool downsample used to build input pyramids, NHWC."""
    n, h, w, c = x.shape
    assert h % factor == 0 and w % factor == 0, (h, w, factor)
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))


def space_to_depth(x: Tensor, factor: int = 2) -> Tensor:
    """NHWC (N, H, W, C) -> (N, H/f, W/f, f*f*C), as the JAX package's:
    output channel (dy*f + dx)*C + c holds input pixel (y*f + dy, x*f + dx)
    of channel c. The UNet applies it at its NHWC edge, so the result's
    NCHW view is already in channels_last memory."""
    n, h, w, c = x.shape
    f = factor
    if h % f or w % f:
        raise ValueError(f"space_to_depth: {h}x{w} is not divisible by {f}")
    x = x.reshape(n, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // f, w // f, f * f * c)


def depth_to_space(x: Tensor, factor: int = 2) -> Tensor:
    """Inverse of space_to_depth: NHWC (N, H, W, f*f*C) -> (N, H*f, W*f, C)."""
    n, h, w, c = x.shape
    f = factor
    if c % (f * f):
        raise ValueError(f"depth_to_space: {c} channels are not divisible by {f * f}")
    co = c // (f * f)
    x = x.reshape(n, h, w, f, f, co)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * f, w * f, co)
