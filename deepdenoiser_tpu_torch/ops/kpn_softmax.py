"""The KPN head's logits -> filter weights for one slot: the wrapper of
csrc/kpn_softmax.cu.

    rms = sqrt(mean_t(l_t²) + 1e-8);  z_t = l_t / rms * tau   (tau given)
    w = softmax_t(z)                                          (z = l without tau)

over the k² taps of every pixel. It replaces no TPU kernel: the JAX head
(deepdenoiser_tpu/models/kpn.py) leaves this chain to XLA, which fuses it;
the kernel does the same for the port in one pass over the slot's logits
(its design note is in the CUDA source).

`KpnSoftmax.apply(logits, tau)`, a torch.autograd.Function, takes the
slot's (N,H,W,k²) logits, a view with the taps contiguous (the head's
slice of the backbone's output, its pixels n_slots·k² floats apart), and
the slot's temperature, a 0-d tensor (the head passes the view taus[s]),
or None, and returns the contiguous (N,H,W,k²) fp32 weights that the
filter apply (ops/kpn_apply.py) takes. The logits are fp32; at k² = 441
(k = 21, the KPCN's head) they may be bf16 too, read in place and computed
in fp32 (`reads_in_place`). An output may pass 2**31 elements (offsets are
64-bit); its pixels may not.
Tensors on the CPU take `softmax_plain` (bf16 logits in fp32) and count
no launch; tensors on the card launch the kernel or raise — there is no
fallback. τ is read on the card, through a pointer: no host sync. The
backward recomputes `softmax_plain` on the saved inputs and differentiates
it, so the gradients for the logits and τ are those of the plain chain
(τ's flows back through the head's view into the temperature vector).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepdenoiser_tpu_torch.ops import _build

Tensor = torch.Tensor

TAPS = (9, 25, 441)  # k² for k in {3, 5, 21}
BF16_TAPS = (441,)  # where the kernel reads bf16 logits too
RMS_EPS = 1e-8
MAX_PIXELS = 0x7FFFFFFF  # pixel indices are 32-bit; element offsets 64-bit

# CUDA launches of the kernel since the last reset (a plain count; the
# wrapper adds one where it launches and nowhere else).
launches = 0

_fns: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0


def softmax_plain(logits: Tensor, tau: Optional[Tensor]) -> Tensor:
    """The plain PyTorch version, in the logits' dtype: the RMS norm and
    temperature when `tau` is given, then the softmax over the taps."""
    if tau is not None:
        rms = torch.sqrt(torch.mean(logits * logits, dim=-1, keepdim=True) + RMS_EPS)
        logits = logits / rms * tau
    return torch.softmax(logits, dim=-1)


def _widened(logits: Tensor) -> Tensor:
    """bf16 logits as fp32, the kernel's arithmetic; others as they are."""
    return logits.float() if logits.dtype == torch.bfloat16 else logits


def reads_in_place(logits: Tensor) -> bool:
    """Whether the kernel reads these logits as they are: fp32, or bf16 at
    k² in BF16_TAPS. Others are cast to fp32 first (the head does so)."""
    return logits.dtype == torch.float32 or (
        logits.dtype == torch.bfloat16 and logits.dim() > 0 and logits.shape[-1] in BF16_TAPS)


class KpnSoftmax(torch.autograd.Function):
    """The norm and softmax of one slot; the backward is the plain chain's."""

    @staticmethod
    def forward(ctx, logits: Tensor, tau: Optional[Tensor]) -> Tensor:
        ctx.save_for_backward(logits, tau)
        if all(t.device.type == "cpu" for t in (logits, tau) if t is not None):
            return softmax_plain(_widened(logits), tau)
        return softmax_cuda(logits, tau)

    @staticmethod
    def backward(ctx, g: Tensor):
        logits, tau = ctx.saved_tensors
        need_l, need_t = ctx.needs_input_grad
        with torch.enable_grad():
            l = logits.detach().requires_grad_(need_l)
            t = tau.detach().requires_grad_(need_t) if tau is not None else None
            w = softmax_plain(_widened(l), t)
            wanted = [x for x, need in ((l, need_l), (t, need_t)) if need]
            grads = iter(torch.autograd.grad(w, wanted, g))
        return (next(grads) if need_l else None), (next(grads) if need_t else None)


def _check(logits: Tensor, tau: Optional[Tensor]) -> tuple:
    """Dtype, shape and stride checks first (they need no card), then the
    device; returns (n, h, w, k²)."""
    tensors = {"logits": logits} if tau is None else {"logits": logits, "tau": tau}
    for name, t in tensors.items():
        if t.dtype != torch.float32 and not (name == "logits" and reads_in_place(t)):
            raise TypeError(f"kpn_softmax: fp32 only (bf16 logits at k² in {BF16_TAPS}), "
                            f"{name} is {t.dtype}")
    if logits.dim() != 4 or logits.shape[-1] not in TAPS:
        raise ValueError(f"kpn_softmax: logits must be (N,H,W,k²), k² in {TAPS}, "
                         f"got {tuple(logits.shape)}")
    if logits.stride(-1) != 1:
        raise ValueError(f"kpn_softmax: the taps must be contiguous (stride 1), "
                         f"got strides {logits.stride()}")
    if min(logits.stride()) < 0:
        raise ValueError("kpn_softmax: logits has negative strides")
    if logits.numel() // logits.shape[-1] > MAX_PIXELS:
        raise ValueError(f"kpn_softmax: {logits.numel() // logits.shape[-1]} pixels, "
                         "at most 2**31 - 1")
    if tau is not None and tau.dim() != 0:
        raise ValueError(f"kpn_softmax: tau must be a 0-d tensor, got shape {tuple(tau.shape)}")
    if logits.device.type != "cuda" or any(t.device != logits.device for t in tensors.values()):
        devs = ", ".join(f"{name} on {t.device}" for name, t in tensors.items())
        raise ValueError(f"kpn_softmax: {devs}; all must be on the same CUDA device")
    return tuple(logits.shape)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("kpn_softmax"), name)
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def softmax_cuda(logits: Tensor, tau: Optional[Tensor]) -> Tensor:
    """Launch the kernel on the current stream; no synchronise. Returns a
    new contiguous (N,H,W,k²) fp32 tensor."""
    global launches
    n, h, w, k2 = _check(logits, tau)
    out = torch.empty((n, h, w, k2), dtype=torch.float32, device=logits.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        entry = "kpn_softmax_f32" if logits.dtype == torch.float32 else "kpn_softmax_bf16"
        err = _kernel(entry)(logits.data_ptr(), None if tau is None else tau.data_ptr(),
                             out.data_ptr(), n, h, w, k2, *logits.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"kpn_softmax: kernel launch failed with cudaError {err}")
    launches += 1
    return out
