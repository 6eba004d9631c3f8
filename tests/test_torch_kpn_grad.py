"""The KPN filter apply's backward: the port's plain backward
(models/kpn.apply_per_pixel_kernels_bwd) against the JAX package's
custom_vjp backward (_kpn_pallas_bwd) and jax.grad of the Pallas apply in
interpret mode; the autograd function ops/kpn_apply.KpnApply on the CPU;
and the KPN head's gradients against jax.grad of the JAX head.

The backward kernels themselves (csrc/kpn_apply_bwd.cu) run only on the
card: tests/test_torch_gpu.py and chip_smoke.py hold them to the plain
backward there.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.models import kpn as jkpn
from deepdenoiser_tpu.ops import kpn_pallas
from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import kpn_apply

ATOL = 1e-5


def _inputs(seed, shape, k):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    noisy = rng.random(shape).astype(np.float32)
    logits = rng.standard_normal((n, h, w, k * k)).astype(np.float32)
    weights = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    g = rng.standard_normal(shape).astype(np.float32)
    return noisy, weights, g


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("k", [3, 5])
def test_plain_backward_matches_the_custom_vjp_backward(k, c):
    noisy, weights, g = _inputs(k * 10 + c, (2, 11, 13, c), k)
    want_n, want_w = kpn_pallas._kpn_pallas_bwd(
        k, True, (jnp.asarray(noisy), jnp.asarray(weights)), jnp.asarray(g))
    got_n, got_w = kpn.apply_per_pixel_kernels_bwd(
        torch.from_numpy(noisy), torch.from_numpy(weights), torch.from_numpy(g), k, True)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("k", [3, 5])
def test_plain_backward_matches_jax_grad_of_the_pallas_apply(k, c):
    noisy, weights, g = _inputs(k * 7 + c, (1, 9, 15, c), k)

    def loss(x, w):
        return jnp.sum(kpn_pallas.apply_per_pixel_kernels_pallas(x, w, k, True) * jnp.asarray(g))

    want_n, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(noisy), jnp.asarray(weights))
    got_n, got_w = kpn.apply_per_pixel_kernels_bwd(
        torch.from_numpy(noisy), torch.from_numpy(weights), torch.from_numpy(g), k, True)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)


def test_plain_backward_without_the_signal_gradient():
    noisy, weights, g = _inputs(1, (1, 8, 10, 3), 5)
    d_n, d_w = kpn.apply_per_pixel_kernels_bwd(
        torch.from_numpy(noisy), torch.from_numpy(weights), torch.from_numpy(g), 5, False)
    _, want_w = kpn.apply_per_pixel_kernels_bwd(
        torch.from_numpy(noisy), torch.from_numpy(weights), torch.from_numpy(g), 5, True)
    assert d_n is None
    torch.testing.assert_close(d_w, want_w, rtol=0, atol=0)


@pytest.mark.parametrize("k", [3, 5])
def test_kpn_apply_on_the_cpu_matches_autograd_through_the_plain_forward(k):
    noisy, weights, g = _inputs(2 + k, (2, 10, 7, 3), k)
    x1 = torch.from_numpy(noisy).requires_grad_()
    w1 = torch.from_numpy(weights).requires_grad_()
    kpn_apply.reset_launches()
    out = kpn_apply.apply_per_pixel_kernels(x1, w1, k)
    (out * torch.from_numpy(g)).sum().backward()
    assert (kpn_apply.launches, kpn_apply.bwd_weights_launches, kpn_apply.bwd_noisy_launches) == (0, 0, 0)
    x2 = torch.from_numpy(noisy).requires_grad_()
    w2 = torch.from_numpy(weights).requires_grad_()
    (kpn.apply_per_pixel_kernels(x2, w2, k) * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(out, kpn.apply_per_pixel_kernels(x2, w2, k), rtol=0, atol=0)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=0, atol=ATOL)


def test_kpn_apply_gradient_matches_finite_differences():
    """The autograd function's backward is the derivative of its forward:
    central differences of the fp32 plain forward at a few elements (the
    forward is linear in each input, so only rounding separates them)."""
    noisy, weights, g = _inputs(9, (1, 5, 6, 2), 3)
    x = torch.from_numpy(noisy).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    out = kpn_apply.apply_per_pixel_kernels(x, w, 3)
    dx, dw = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (x, w))
    eps = 1e-2
    for t, grad, idx in ((x, dx, (0, 2, 3, 1)), (w, dw, (0, 4, 1, 7))):
        hi, lo = t.detach().clone(), t.detach().clone()
        hi[idx] += eps
        lo[idx] -= eps
        args = (hi, w.detach()) if t is x else (x.detach(), hi)
        args_lo = (lo, w.detach()) if t is x else (x.detach(), lo)
        f_hi = (kpn.apply_per_pixel_kernels(*args, 3) * torch.from_numpy(g)).sum()
        f_lo = (kpn.apply_per_pixel_kernels(*args_lo, 3) * torch.from_numpy(g)).sum()
        assert abs(float((f_hi - f_lo) / (2 * eps)) - float(grad[idx])) <= 1e-3


@pytest.mark.parametrize("noisy_grad,weights_grad", [(False, True), (True, False), (True, True)])
def test_backward_computes_only_the_gradients_asked_for(monkeypatch, noisy_grad, weights_grad):
    calls = []
    plain = kpn.apply_per_pixel_kernels_bwd

    def spy(noisy, weights, g, k, need_noisy):
        calls.append(need_noisy)
        return plain(noisy, weights, g, k, need_noisy)

    monkeypatch.setattr(kpn, "apply_per_pixel_kernels_bwd", spy)
    noisy, weights, g = _inputs(3, (1, 6, 9, 3), 5)
    x = torch.from_numpy(noisy).requires_grad_(noisy_grad)
    w = torch.from_numpy(weights).requires_grad_(weights_grad)
    (kpn_apply.apply_per_pixel_kernels(x, w, 5) * torch.from_numpy(g)).sum().backward()
    assert calls == [noisy_grad]
    assert (x.grad is not None) == noisy_grad and (w.grad is not None) == weights_grad


def test_inference_mode_runs_only_the_forward():
    noisy, weights, _ = _inputs(4, (1, 6, 9, 3), 5)
    with torch.inference_mode():
        out = kpn_apply.apply_per_pixel_kernels(torch.from_numpy(noisy), torch.from_numpy(weights), 5)
    assert not out.requires_grad


@pytest.mark.parametrize("entry", ["bwd_weights_cuda", "bwd_noisy_cuda"])
def test_backward_kernel_entries_refuse_cpu_tensors_and_other_sizes(entry):
    """The CUDA entry points never fall back: CPU tensors and kernel sizes
    other than 3 and 5 are errors there."""
    fn = getattr(kpn_apply, entry)
    a, b = torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3)
    if entry == "bwd_noisy_cuda":
        b = torch.zeros(1, 4, 4, 25)
    with pytest.raises(ValueError, match="CUDA"):
        fn(a, b, 5)
    with pytest.raises(ValueError, match="kernel_size"):
        fn(a, b, 7)


class _Identity(fnn.Module):
    """Stand-in backbone: the JAX head then sees the given logits."""

    @fnn.compact
    def __call__(self, x):
        return x


@pytest.mark.parametrize("logit_norm", [True, False])
@pytest.mark.parametrize("k,n_slots", [(5, 8), (3, 2)])
def test_head_gradients_match_jax(k, n_slots, logit_norm):
    """d(loss)/d(logits) and d(loss)/d(kernel_temp) of the port's head
    (through KpnApply) against jax.grad of the JAX head (through its
    shift-accumulate apply) on the same temperatures."""
    rng = np.random.default_rng(20 + k)
    n, h, w = 2, 9, 11
    feats = (3 * rng.standard_normal((n, h, w, n_slots * k * k))).astype(np.float32)
    signal = rng.random((n, h, w, 3 * n_slots)).astype(np.float32)
    cot = rng.standard_normal((n, h, w, 3 * n_slots)).astype(np.float32)
    temps = rng.standard_normal(n_slots).astype(np.float32)
    jhead = jkpn.KernelPredictionHead(_Identity(), kernel_size=k, n_slots=n_slots,
                                      logit_norm=logit_norm)
    params = {"params": {"kernel_temp": jnp.asarray(temps)}} if logit_norm else {}

    def loss(p, f):
        return jnp.sum(jhead.apply(p, f, jnp.asarray(signal)) * jnp.asarray(cot))

    if logit_norm:
        jgrad_p, jgrad_f = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    else:
        jgrad_f = jax.grad(loss, argnums=1)(params, jnp.asarray(feats))

    head = kpn.KernelPredictionHead(k, n_slots, logit_norm=logit_norm)
    if logit_norm:
        head.load_state_dict({"kernel_temp": torch.from_numpy(temps)})
    f = torch.from_numpy(feats).requires_grad_()
    (head(f, torch.from_numpy(signal)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad_f), atol=ATOL)
    if logit_norm:
        want = np.asarray(jgrad_p["params"]["kernel_temp"])
        np.testing.assert_allclose(head.kernel_temp.grad.numpy(), want, rtol=1e-4, atol=ATOL)
