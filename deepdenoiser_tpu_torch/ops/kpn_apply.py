"""Kernel-prediction filter apply: the wrapper of csrc/kpn_apply.cu.

Replaces deepdenoiser_tpu/ops/kpn_pallas.py::_kernel /
apply_per_pixel_kernels_pallas, the TPU kernel the joint kpn-hq frame
launches once per slot (8 per frame). The kernel is memory-bound (124 B
against 150 FLOP per pixel at k=5, C=3); its design note is in the CUDA
source.

`apply_per_pixel_kernels(noisy, weights, k)` keeps the JAX signature:
noisy (N,H,W,C) and per-pixel softmaxed weights (N,H,W,k²), both fp32,
-> (N,H,W,C) fp32. Tensors on the CPU go to the plain PyTorch version
(models/kpn.py) and do not count as launches; tensors on the card launch
the kernel or raise — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from deepdenoiser_tpu_torch.ops import _build

Tensor = torch.Tensor

MAX_CHANNELS = 4  # the kernel's per-thread accumulator count
KERNEL_SIZES = (3, 5)

# Launches of the CUDA kernel since the last reset (a plain count; the
# wrapper adds one where it launches and nowhere else).
launches = 0

_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("kpn_apply").kpn_apply_f32
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def apply_per_pixel_kernels(noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """Filter `noisy` with per-pixel kernels: the CUDA kernel on the card,
    the plain version for CPU tensors."""
    if noisy.device.type == "cpu" and weights.device.type == "cpu":
        from deepdenoiser_tpu_torch.models.kpn import apply_per_pixel_kernels as plain

        return plain(noisy, weights, kernel_size)
    return apply_cuda(noisy, weights, kernel_size)


def apply_cuda(noisy: Tensor, weights: Tensor, kernel_size: int) -> Tensor:
    """Launch the kernel on the current stream; no synchronise. Inputs may
    be strided views (the noisy signal's channels must be contiguous)."""
    global launches
    k = kernel_size
    if k not in KERNEL_SIZES:
        raise ValueError(f"kpn_apply: kernel_size {k} not in {KERNEL_SIZES}")
    if noisy.device.type != "cuda" or weights.device != noisy.device:
        raise ValueError(
            f"kpn_apply: noisy on {noisy.device} and weights on {weights.device}; "
            "both must be on the same CUDA device"
        )
    if noisy.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"kpn_apply: fp32 only, got {noisy.dtype} and {weights.dtype}")
    if noisy.dim() != 4:
        raise ValueError(f"kpn_apply: noisy must be (N,H,W,C), got {tuple(noisy.shape)}")
    n, h, w, c = noisy.shape
    if tuple(weights.shape) != (n, h, w, k * k):
        raise ValueError(f"kpn_apply: weights {tuple(weights.shape)} != {(n, h, w, k * k)}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"kpn_apply: 1..{MAX_CHANNELS} channels, got {c}")
    if c > 1 and noisy.stride(3) != 1:
        raise ValueError("kpn_apply: noisy channels must be contiguous (stride 1)")
    if min(noisy.stride()) < 0 or min(weights.stride()) < 0:
        raise ValueError("kpn_apply: negative strides")
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=noisy.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(noisy.device):
        stream = torch.cuda.current_stream(noisy.device).cuda_stream
        err = _kernel()(
            noisy.data_ptr(), weights.data_ptr(), out.data_ptr(),
            n, h, w, c, k,
            *noisy.stride(),
            weights.stride(0), weights.stride(3), weights.stride(1), weights.stride(2),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"kpn_apply: kernel launch failed with cudaError {err}")
    launches += 1
    return out
