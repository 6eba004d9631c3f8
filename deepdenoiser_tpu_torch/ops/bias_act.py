"""A conv's bias and activation as one pass: the wrapper of csrc/bias_act.cu.

    out = act(z + b.to(dtype))      (the sum rounded to dtype)

over a conv's bias-less output z, a dense (N,C,H,W) tensor in bf16 or
fp32, channels-last or contiguous NCHW, with b the layer's (C,) bias
(fp32, or z's dtype) and act a name of `ACTIVATIONS`, the port's table of
activations. It replaces no TPU kernel: XLA fuses the bias and the
activation into the conv; the kernel does the same for the port after
cuDNN's conv, in one read and one write of the output (its design note is
in the CUDA source).

`bias_act(z, b, act)` is the entry point. Tensors on the CPU take
`bias_act_plain` and count no launch; tensors on the card launch the kernel
or raise — there is no fallback. Without gradients (the frame path, under
inference mode) the kernel writes z in place and returns it. Where z or b
requires grad, it goes through `BiasAct`, a torch.autograd.Function: the
kernel writes a new tensor. For none, relu and leaky_relu the backward
reads the output alone, as PyTorch's own backward of those activations
does, and sums the bias gradient; for elu, gelu and silu z is saved and
the backward recomputes `bias_act_plain` and differentiates it. Either way
the gradients are the plain chain's. The arguments are checked on every
device alike; z must be 16-byte aligned, as every fresh allocation is. A z
of more than 2**31 - 1 elements (MAX_ELEMENTS; the KPCN's logits) takes
the kernel's wide instantiation, with 64-bit offsets; any smaller z the
32-bit one.

`bias_act_subpixel(z, b, act)` is the epilogue of the decoder's resize-conv
(models/layers.py, UpSample), whose conv runs on the coarse grid: z is the
(N, 4F, H+1, W+1) phase tensor of a 2x2 conv with padding 1, phase (r, q)
of coarse pixel (i, j) at position (i+r, j+q) in channel block (2r+q)F.
It returns the (N, F, 2H, 2W) channels-last

    out[n, f, 2i+r, 2j+q] = act(z[n, (2r+q)F + f, i+r, j+q] + b[f])

On the card without gradients one launch of the kernel's sub-pixel
instantiation reads the phases and writes `out`, a new tensor; on the CPU
and under grad the phases are interleaved in plain PyTorch
(`interleave_phases`) and go through `bias_act`.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

from deepdenoiser_tpu_torch.ops import _build

Tensor = torch.Tensor

ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "silu": F.silu,
    "none": lambda x: x,
}
# the kernel's code of each (csrc/bias_act.cu, enum Act)
ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "elu": 3, "gelu": 4, "silu": 5}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 12288  # the staged bias fills at most 48 KB of shared memory
MAX_ELEMENTS = 0x7FFFFFFF  # the 32-bit instantiation's; the sub-pixel epilogue's limit

# CUDA launches of the kernel since the last reset (a plain count; the
# wrapper adds one where it launches and nowhere else), and those of them
# that were the sub-pixel epilogue.
launches = 0
subpixel_launches = 0

_fn = None
_subpixel_fn = None


def reset_launches() -> None:
    global launches, subpixel_launches
    launches = subpixel_launches = 0


def bias_act_plain(z: Tensor, b: Tensor, act: str) -> Tensor:
    """The plain PyTorch version, the chain PyTorch runs after a cuDNN
    conv: the bias cast to z's dtype and added (the sum rounded to it), then
    the activation."""
    return ACTIVATIONS[act](z + b.to(z.dtype).view(1, -1, 1, 1))


def _check(z: Tensor, b: Tensor, act: str, phases: int = 1) -> bool:
    """Activation, dtype, shape and stride checks first (they need no
    card), then the device; returns whether z is laid out NCHW (else
    channels-last). `phases` 4: z holds four blocks of b's channels (the
    sub-pixel epilogue's phase tensor)."""
    if act not in ACT_CODES:
        raise KeyError(f"bias_act: unknown activation {act!r}; known: {sorted(ACT_CODES)}")
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"bias_act: z must be bfloat16 or float32, got {z.dtype}")
    if b.dtype not in (torch.float32, z.dtype):
        raise TypeError(f"bias_act: b must be float32 or z's {z.dtype}, got {b.dtype}")
    if z.dim() != 4 or b.dim() != 1 or b.shape[0] * phases != z.shape[1]:
        bias = "(C,)" if phases == 1 else f"(C/{phases},)"
        raise ValueError(f"bias_act: z must be (N,C,H,W) and b {bias}, got {tuple(z.shape)} "
                         f"and {tuple(b.shape)}")
    if z.is_contiguous():
        planar = True
    elif z.is_contiguous(memory_format=torch.channels_last):
        planar = False
    else:
        raise ValueError(f"bias_act: z must be dense, NCHW or channels-last, got strides "
                         f"{z.stride()} for shape {tuple(z.shape)}")
    if not b.is_contiguous():
        raise ValueError(f"bias_act: b must be contiguous, got stride {b.stride()}")
    if b.shape[0] > MAX_CHANNELS:
        raise ValueError(f"bias_act: {b.shape[0]} channels, at most {MAX_CHANNELS}")
    if z.device != b.device:
        raise ValueError(f"bias_act: z on {z.device}, b on {b.device}; both must be on one device")
    if z.data_ptr() % 16:
        raise ValueError(f"bias_act: z must be 16-byte aligned, got address {z.data_ptr():#x}")
    return planar


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("bias_act").bias_act
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _subpixel_kernel():
    global _subpixel_fn
    if _subpixel_fn is None:
        fn = _build.load("bias_act").bias_act_subpixel
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _subpixel_fn = fn
    return _subpixel_fn


def bias_act_cuda(z: Tensor, b: Tensor, act: str, out: Tensor) -> Tensor:
    """Launch the kernel on the current stream, writing `out` (z itself, or
    a tensor laid out as z); no synchronise. Returns `out`."""
    global launches
    planar = _check(z, b, act)
    if z.device.type != "cuda":
        raise ValueError(f"bias_act: z on {z.device}; the kernel takes CUDA tensors")
    if out.shape != z.shape or out.dtype != z.dtype or out.stride() != z.stride() \
            or out.device != z.device or out.data_ptr() % 16:
        raise ValueError("bias_act: out must have z's shape, dtype, strides and device, "
                         "16-byte aligned")
    if z.numel() == 0:
        return out
    b = b.float()
    n, c, h, w = z.shape
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = _kernel()(z.data_ptr(), b.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype],
                        ACT_CODES[act], int(planar), z.numel(), c, h * w, stream)
    if err != 0:
        raise RuntimeError(f"bias_act: kernel launch failed with cudaError {err}")
    launches += 1
    return out


# the activations whose gradient PyTorch reads off their output alone:
# name -> (grad of the output, the output) -> grad of the rounded sum
_FROM_OUTPUT: dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "none": lambda g, y: g,
    "relu": lambda g, y: torch.ops.aten.threshold_backward(g, y, 0),
    "leaky_relu": lambda g, y: torch.ops.aten.leaky_relu_backward(g, y, 0.2, True),
}


class BiasAct(torch.autograd.Function):
    """The bias and activation where gradients are wanted; the gradients
    are the plain chain's, bit for bit."""

    @staticmethod
    def forward(ctx, z: Tensor, b: Tensor, act: str) -> Tensor:
        ctx.act, ctx.b_dtype = act, b.dtype
        if z.device.type == "cpu":
            _check(z, b, act)
            out = bias_act_plain(z, b, act)
        else:
            out = bias_act_cuda(z, b, act, torch.empty_like(z))
        if act == "none":
            ctx.save_for_backward()
        elif act in _FROM_OUTPUT:
            ctx.save_for_backward(out)
        else:
            ctx.save_for_backward(z, b)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        need_z, need_b, _ = ctx.needs_input_grad
        if ctx.act in _FROM_OUTPUT:
            (y,) = ctx.saved_tensors or (None,)
            gz = _FROM_OUTPUT[ctx.act](g, y)
            # the broadcast add's gradient: summed in the working dtype, then cast
            gb = gz.sum((0, 2, 3)).to(ctx.b_dtype) if need_b else None
            return (gz if need_z else None), gb, None
        z, b = ctx.saved_tensors
        with torch.enable_grad():
            zz = z.detach().requires_grad_(need_z)
            bb = b.detach().requires_grad_(need_b)
            y = bias_act_plain(zz, bb, ctx.act)
            wanted = [x for x, need in ((zz, need_z), (bb, need_b)) if need]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (next(grads) if need_z else None), (next(grads) if need_b else None), None


def bias_act(z: Tensor, b: Tensor, act: str) -> Tensor:
    """act(z + b) for a conv's bias-less output z and its bias b. Without
    gradients a CUDA z is overwritten and returned."""
    if torch.is_grad_enabled() and (z.requires_grad or b.requires_grad):
        return BiasAct.apply(z, b, act)
    if z.device.type == "cpu":
        _check(z, b, act)
        return bias_act_plain(z, b, act)
    return bias_act_cuda(z, b, act, z)


def _phase_shape(z: Tensor) -> tuple[int, int, int, int]:
    """(N, F, H, W) of a (N, 4F, H+1, W+1) phase tensor."""
    if z.dim() != 4 or z.shape[1] % 4 or z.shape[2] < 2 or z.shape[3] < 2:
        raise ValueError(f"bias_act_subpixel: z must be (N, 4F, H+1, W+1) with H, W >= 1, "
                         f"got {tuple(z.shape)}")
    n, c4, hz, wz = z.shape
    return n, c4 // 4, hz - 1, wz - 1


def interleave_phases(z: Tensor) -> Tensor:
    """The plain interleave: the (N, 4F, H+1, W+1) phase tensor to the
    (N, F, 2H, 2W) tensor, channels-last, with out[n, f, 2i+r, 2j+q] =
    z[n, (2r+q)F + f, i+r, j+q] (slices, a stack and a copy)."""
    n, f, h, w = _phase_shape(z)
    zp = z.permute(0, 2, 3, 1).reshape(n, h + 1, w + 1, 2, 2, f)
    rows = [torch.stack([zp[:, r:r + h, q:q + w, r, q] for q in (0, 1)], dim=3) for r in (0, 1)]
    out = torch.stack(rows, dim=2).reshape(n, 2 * h, 2 * w, f)
    return out.permute(0, 3, 1, 2)


def bias_act_subpixel_plain(z: Tensor, b: Tensor, act: str) -> Tensor:
    """The plain version of the sub-pixel epilogue: the interleave, then
    `bias_act_plain`."""
    return bias_act_plain(interleave_phases(z), b, act)


def bias_act_subpixel_cuda(z: Tensor, b: Tensor, act: str) -> Tensor:
    """Launch the sub-pixel instantiation on the current stream; returns the
    new (N, F, 2H, 2W) channels-last output. No synchronise."""
    global launches, subpixel_launches
    n, f, h, w = _phase_shape(z)
    if _check(z, b, act, phases=4):
        raise ValueError(f"bias_act_subpixel: z must be channels-last, got strides "
                         f"{z.stride()} for shape {tuple(z.shape)}")
    if z.device.type != "cuda":
        raise ValueError(f"bias_act_subpixel: z on {z.device}; the kernel takes CUDA tensors")
    if max(z.numel(), 4 * n * f * h * w) > MAX_ELEMENTS:
        raise ValueError(f"bias_act_subpixel: {z.numel()} elements, at most 2**31 - 1")
    out = torch.empty((n, f, 2 * h, 2 * w), dtype=z.dtype, device=z.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    b = b.float()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = _subpixel_kernel()(z.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 DTYPE_CODES[z.dtype], ACT_CODES[act], out.numel(), f, h, w,
                                 stream)
    if err != 0:
        raise RuntimeError(f"bias_act_subpixel: kernel launch failed with cudaError {err}")
    launches += 1
    subpixel_launches += 1
    return out


def bias_act_subpixel(z: Tensor, b: Tensor, act: str) -> Tensor:
    """act(interleaved z + b) for the phase tensor z of the resize-conv and
    its bias b (F,): one launch on the card without gradients, else the
    plain interleave and `bias_act`."""
    grad = torch.is_grad_enabled() and (z.requires_grad or b.requires_grad)
    if grad or z.device.type == "cpu":
        return bias_act(interleave_phases(z), b, act)
    return bias_act_subpixel_cuda(z, b, act)
