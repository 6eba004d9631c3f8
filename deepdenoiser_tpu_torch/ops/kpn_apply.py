"""Kernel-prediction filter apply and its backward: the wrappers of
csrc/kpn_apply.cu and csrc/kpn_apply_bwd.cu.

The forward replaces deepdenoiser_tpu/ops/kpn_pallas.py::_kernel /
apply_per_pixel_kernels_pallas, the TPU kernel the joint kpn-hq frame
launches once per slot (8 per frame); the backward replaces that
function's custom_vjp backward, _kpn_pallas_bwd. All three kernels are
memory-bound (124 B against 150 FLOP per pixel at k=5, C=3); their design
notes are in the CUDA sources.

`apply_per_pixel_kernels(noisy, weights, k)` keeps the JAX signature:
noisy (N,H,W,C) and per-pixel softmaxed weights (N,H,W,k²), both fp32,
-> (N,H,W,C) fp32. It goes through `KpnApply`, a torch.autograd.Function:
tensors on the CPU take the plain PyTorch versions (models/kpn.py) forward
and backward and count no launch; tensors on the card launch the kernels
or raise — there is no fallback. The backward computes only the gradients
autograd asks for (`ctx.needs_input_grad`): in training the signal is a
slice of the network input, so only the weight gradient is launched.
"""

from __future__ import annotations

import ctypes

import torch

from deepdenoiser_tpu_torch.ops import _build

Tensor = torch.Tensor

MAX_CHANNELS = 4  # the kernels' per-thread accumulator count
KERNEL_SIZES = (3, 5)

# Launches of each CUDA kernel since the last reset (plain counts; each
# wrapper adds one where it launches and nowhere else).
launches = 0
bwd_weights_launches = 0
bwd_noisy_launches = 0

_fns: dict = {}


def reset_launches() -> None:
    global launches, bwd_weights_launches, bwd_noisy_launches
    launches = bwd_weights_launches = bwd_noisy_launches = 0


def _kernel(lib: str, name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def apply_per_pixel_kernels(noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """Filter `noisy` with per-pixel kernels, differentiably: the CUDA
    kernels on the card, the plain versions for CPU tensors."""
    return KpnApply.apply(noisy, weights, kernel_size)


def _on_cpu(*ts: Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


class KpnApply(torch.autograd.Function):
    """The filter apply with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
        ctx.kernel_size = kernel_size
        ctx.save_for_backward(noisy, weights)
        if _on_cpu(noisy, weights):
            from deepdenoiser_tpu_torch.models.kpn import apply_per_pixel_kernels as plain

            return plain(noisy, weights, kernel_size)
        return apply_cuda(noisy, weights, kernel_size)

    @staticmethod
    def backward(ctx, g: Tensor):
        noisy, weights = ctx.saved_tensors
        k = ctx.kernel_size
        need_noisy, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        if _on_cpu(noisy, weights, g):
            from deepdenoiser_tpu_torch.models.kpn import apply_per_pixel_kernels_bwd as plain

            d_noisy, d_w = plain(noisy, weights, g, k, need_noisy)
            return d_noisy, (d_w if need_w else None), None
        d_w = bwd_weights_cuda(noisy, g, k) if need_w else None
        d_noisy = bwd_noisy_cuda(g, weights, k) if need_noisy else None
        return d_noisy, d_w, None


def _check(what: str, tensors: dict, kernel_size: int) -> tuple:
    """Device, dtype, shape and stride checks shared by the three kernels;
    returns (n, h, w, c) from the (N,H,W,C) tensor named first."""
    k = kernel_size
    if k not in KERNEL_SIZES:
        raise ValueError(f"{what}: kernel_size {k} not in {KERNEL_SIZES}")
    (_, ref), *rest = tensors.items()
    if ref.device.type != "cuda" or any(t.device != ref.device for t in tensors.values()):
        devs = ", ".join(f"{name} on {t.device}" for name, t in tensors.items())
        raise ValueError(f"{what}: {devs}; all must be on the same CUDA device")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: fp32 only, {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-D, got {tuple(t.shape)}")
        if min(t.stride()) < 0:
            raise ValueError(f"{what}: {name} has negative strides")
    n, h, w, c = ref.shape
    for name, t in rest:
        want = (n, h, w, k * k) if name == "weights" else (n, h, w, c)
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != {want}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{what}: 1..{MAX_CHANNELS} channels, got {c}")
    return n, h, w, c


def _launch(what: str, fn, ptrs, dims, strides, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *dims, *strides, stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {err}")


def _w_strides(weights: Tensor) -> tuple:
    """(n, tap, y, x) element strides of an (N,H,W,k²) weight view."""
    return weights.stride(0), weights.stride(3), weights.stride(1), weights.stride(2)


def apply_cuda(noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """Launch the forward kernel on the current stream; no synchronise.
    Inputs may be strided views (the noisy signal's channels must be
    contiguous)."""
    global launches
    k = kernel_size
    n, h, w, c = _check("kpn_apply", {"noisy": noisy, "weights": weights}, k)
    if c > 1 and noisy.stride(3) != 1:
        raise ValueError("kpn_apply: noisy channels must be contiguous (stride 1)")
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=noisy.device)
    if out.numel() == 0:
        return out
    _launch("kpn_apply", _kernel("kpn_apply", "kpn_apply_f32"),
            (noisy.data_ptr(), weights.data_ptr(), out.data_ptr()), (n, h, w, c, k),
            (*noisy.stride(), *_w_strides(weights)), noisy.device)
    launches += 1
    return out


def bwd_weights_cuda(noisy: Tensor, g: Tensor, kernel_size: int) -> Tensor:
    """d_w (N,H,W,k²): a permuted view of the planar (N,k²,H,W) result.
    Launches on the current stream; no synchronise."""
    global bwd_weights_launches
    k = kernel_size
    n, h, w, c = _check("kpn_apply_bwd_weights", {"noisy": noisy, "g": g}, k)
    dw = torch.empty((n, k * k, h, w), dtype=torch.float32, device=noisy.device)
    if dw.numel() == 0:
        return dw.permute(0, 2, 3, 1)
    _launch("kpn_apply_bwd_weights", _kernel("kpn_apply_bwd", "kpn_apply_bwd_weights_f32"),
            (noisy.data_ptr(), g.data_ptr(), dw.data_ptr()), (n, h, w, c, k),
            (*noisy.stride(), *g.stride()), noisy.device)
    bwd_weights_launches += 1
    return dw.permute(0, 2, 3, 1)


def bwd_noisy_cuda(g: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """d_noisy (N,H,W,C), contiguous. Launches on the current stream; no
    synchronise."""
    global bwd_noisy_launches
    k = kernel_size
    n, h, w, c = _check("kpn_apply_bwd_noisy", {"g": g, "weights": weights}, k)
    dn = torch.empty((n, h, w, c), dtype=torch.float32, device=g.device)
    if dn.numel() == 0:
        return dn
    _launch("kpn_apply_bwd_noisy", _kernel("kpn_apply_bwd", "kpn_apply_bwd_noisy_f32"),
            (g.data_ptr(), weights.data_ptr(), dn.data_ptr()), (n, h, w, c, k),
            (*g.stride(), *_w_strides(weights)), g.device)
    bwd_noisy_launches += 1
    return dn
