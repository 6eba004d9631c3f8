"""The KPN head's RMS norm, temperature and softmax as one function a slot
(ops/kpn_softmax.py) on the CPU: its plain version is the head's former
expression, the head's output is unchanged, its backward is the plain
chain's, the CPU launches nothing, and the wrapper's argument checks.

The logits are the head's: slot s of an (N,H,W,n_slots·k²) tensor, a view
whose pixels are n_slots·k² floats apart. The kernel itself is held to the
plain version on the card (tests/test_torch_gpu.py).
"""

import itertools

import pytest
import torch

from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import kpn_apply, kpn_softmax

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread each, so that test workers sharing
    the cores do not spin on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HEADS = [pytest.param(k, slots, norm, n, id=f"k{k}-slots{slots}-{'norm' if norm else 'plain'}-n{n}")
         for k, slots, norm, n in itertools.product((3, 5), (1, 2, 8), (True, False), (1, 4))]


def _former_weights(logits, taus, s, logit_norm):
    """The head's expression before the norm and softmax moved out of it."""
    logits = logits.float()
    if logit_norm:
        rms = torch.sqrt(torch.mean(logits * logits, dim=-1, keepdim=True) + 1e-8)
        logits = logits / rms * taus[s]
    return torch.softmax(logits, dim=-1)


def _former_head(head, feats, signal):
    k2 = head.kernel_size**2
    taus = head.TEMP_MAX * torch.sigmoid(head.kernel_temp.float()) if head.logit_norm else None
    outs = []
    for s in range(head.n_slots):
        weights = _former_weights(feats[..., s * k2 : (s + 1) * k2], taus, s, head.logit_norm)
        outs.append(kpn.apply_per_pixel_kernels(signal[..., 3 * s : 3 * (s + 1)].float(), weights,
                                                head.kernel_size))
    return torch.cat(outs, dim=-1)


def _inputs(k, slots, n, h=5, w=6, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    feats = 3 * torch.randn((n, h, w, slots * k * k), generator=gen, dtype=dtype)
    signal = torch.rand((n, h, w, 3 * slots), generator=gen, dtype=dtype)
    temps = torch.randn((slots,), generator=gen, dtype=dtype)
    return feats, signal, temps


def _head(k, slots, norm, temps):
    head = kpn.KernelPredictionHead(k, slots, logit_norm=norm)
    if norm:
        with torch.no_grad():
            head.kernel_temp.copy_(temps)
    return head


@pytest.mark.parametrize("k,slots,norm,n", HEADS)
def test_plain_forward_is_the_former_head_expression(k, slots, norm, n):
    feats, _, temps = _inputs(k, slots, n)
    taus = 16.0 * torch.sigmoid(temps) if norm else None
    k2 = k * k
    for s in range(slots):
        logits = feats[..., s * k2 : (s + 1) * k2]
        assert logits.stride(-1) == 1 and logits.stride(2) == slots * k2
        tau = taus[s] if norm else None
        got = kpn_softmax.KpnSoftmax.apply(logits, tau)
        assert got.is_contiguous() and got.dtype == torch.float32
        assert torch.equal(got, _former_weights(logits, taus, s, norm))
        assert torch.equal(kpn_softmax.softmax_plain(logits, tau), got)


@pytest.mark.parametrize("k,slots,norm,n", HEADS)
def test_head_output_and_gradients_are_unchanged(k, slots, norm, n):
    feats, signal, temps = _inputs(k, slots, n, seed=1)
    head = _head(k, slots, norm, temps)
    cot = torch.randn((n, 5, 6, 3 * slots), generator=torch.Generator().manual_seed(2))
    f_new, f_old = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    got = head(f_new, signal)
    want = _former_head(head, f_old, signal)
    assert torch.equal(got, want)
    params = [head.kernel_temp] if norm else []
    g_new = torch.autograd.grad((got * cot).sum(), [f_new, *params])
    g_old = torch.autograd.grad((want * cot).sum(), [f_old, *params])
    for a, b in zip(g_new, g_old):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,slots,norm,n", HEADS)
def test_gradcheck_in_float64_for_the_logits_and_the_temperature(k, slots, norm, n):
    feats, _, temps = _inputs(k, slots, n, h=2, w=3, dtype=torch.float64, seed=3)
    k2, s = k * k, slots - 1  # the last slot: the view starts mid-pixel
    # a leaf with the slot view's strides: gradcheck perturbs the slot's taps only
    logits = feats[..., s * k2 : (s + 1) * k2].detach().requires_grad_()
    assert logits.stride(2) == slots * k2

    def weights(lg, *temp):
        tau = 16.0 * torch.sigmoid(temp[0])[s] if temp else None
        return kpn_softmax.KpnSoftmax.apply(lg, tau)

    inputs = (logits,) + ((temps.requires_grad_(),) if norm else ())
    assert torch.autograd.gradcheck(weights, inputs)


@pytest.mark.parametrize("k,slots,norm,n", HEADS)
def test_the_cpu_launches_no_kernel(k, slots, norm, n):
    feats, signal, temps = _inputs(k, slots, n, seed=4)
    head = _head(k, slots, norm, temps)
    kpn_softmax.reset_launches()
    kpn_apply.reset_launches()
    f = feats.requires_grad_()
    head(f, signal).sum().backward()
    assert kpn_softmax.launches == 0 and kpn_apply.launches == 0
    assert f.grad is not None and torch.isfinite(f.grad).all()


def _view(k2=25, slots=8, dtype=torch.float32):
    return torch.randn((1, 4, 5, slots * k2), dtype=dtype)[..., :k2]


REFUSED = {
    "float64 logits": (lambda: (_view(dtype=torch.float64), None), TypeError, "fp32 only"),
    "bfloat16 logits": (lambda: (_view(dtype=torch.bfloat16), None), TypeError, "fp32 only"),
    "float64 tau": (lambda: (_view(), torch.ones((), dtype=torch.float64)), TypeError,
                    "tau is torch.float64"),
    "taps not contiguous": (lambda: (torch.randn((1, 25, 4, 5)).permute(0, 2, 3, 1), None),
                            ValueError, "taps must be contiguous"),
    "every other tap": (lambda: (torch.randn((1, 4, 5, 50))[..., ::2], None), ValueError,
                        "taps must be contiguous"),
    "k² of 16": (lambda: (_view(k2=16), None), ValueError, r"\(N,H,W,k²\)"),
    "3-D logits": (lambda: (torch.randn((4, 5, 25)), None), ValueError, r"\(N,H,W,k²\)"),
    "tau the whole vector": (lambda: (_view(), torch.ones(8)), ValueError, "0-d"),
    "tau of shape (1,)": (lambda: (_view(), torch.ones(1)), ValueError, "0-d"),
    "cpu tensors": (lambda: (_view(), torch.ones(8)[3]), ValueError, "same CUDA device"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_kernel_entry_refuses_what_it_does_not_take(case):
    make, err, match = REFUSED[case]
    kpn_softmax.reset_launches()
    with pytest.raises(err, match=match):
        kpn_softmax.softmax_cuda(*make())
    assert kpn_softmax.launches == 0

