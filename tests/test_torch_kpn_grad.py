"""The KPN filter apply's backward: the port's plain backward
(models/kpn.apply_per_pixel_kernels_bwd) against the JAX package's
custom_vjp backward (_kpn_pallas_bwd), also on the strided slot views
that training hands over, and jax.grad of the Pallas apply in
interpret mode; the autograd function ops/kpn_apply.KpnApply on the CPU,
its gradients (d_w in the head's (N,H,W,k²) layout) against
_kpn_pallas_bwd; the KPN head's gradients against jax.grad of the JAX
head, and a 2-slot KPN model's parameter gradients, from parameters
carried across, against jax.grad of the JAX model (the models' bar,
max|Δ| <= 1e-4 x max|ref| per parameter).

The backward kernels themselves (csrc/kpn_apply_bwd.cu) run only on the
card: tests/test_torch_gpu.py holds them to the plain backward there.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models import kpn as jkpn
from deepdenoiser_tpu.ops import kpn_pallas
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.models import factory, kpn
from deepdenoiser_tpu_torch.ops import kpn_apply

ATOL = 1e-5
MODEL_REL = 1e-4  # models: max|Δ| <= 1e-4 x max|ref| at fp32


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


@pytest.mark.parametrize("signal_stack,grad_stack,slot",
                         [(24, 24, s) for s in range(8)] + [(14, 6, 0), (14, 6, 1)],
                         ids=str)
def test_plain_backward_on_slot_views_matches_the_custom_vjp_backward(signal_stack, grad_stack,
                                                                      slot):
    """The strided views the train step hands the backward: joint mode's
    slot s is channels 3s..3s+2 of the (N,H,W,24) signal and of the head
    output's (N,H,W,24) gradient; group mode's signal is x[..., :6] of the
    14-channel input, its gradient a 6-channel one. The port reads the
    views through their strides; JAX gets the same values as arrays."""
    k = 5
    rng = np.random.default_rng(100 + signal_stack + slot)
    n, h, w = 2, 9, 12
    signal = rng.random((n, h, w, signal_stack)).astype(np.float32)
    grad = rng.standard_normal((n, h, w, grad_stack)).astype(np.float32)
    weights = np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((n, h, w, k * k)).astype(np.float32)), axis=-1))
    ch = slice(3 * slot, 3 * slot + 3)
    want_n, want_w = kpn_pallas._kpn_pallas_bwd(
        k, True, (jnp.asarray(signal[..., ch]), jnp.asarray(weights)), jnp.asarray(grad[..., ch]))
    noisy, g = torch.from_numpy(signal)[..., ch], torch.from_numpy(grad)[..., ch]
    assert noisy.stride(2) == signal_stack and g.stride(2) == grad_stack
    got_n, got_w = kpn.apply_per_pixel_kernels_bwd(noisy, torch.from_numpy(weights), g, k, True)
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


@pytest.mark.parametrize("k,c,hw,stack,slot", [
    *[(k, c, (2, 11, 13), None, 0) for k in (3, 5) for c in (1, 3, 4)],
    (5, 3, (1, 17, 37), None, 0),  # ragged: no multiple of the 32-pixel tile, of 4 or of 8
    (3, 4, (1, 17, 37), None, 0),
    (5, 3, (2, 9, 12), 24, 0),     # slot views of the joint model's 24-channel signal
    (5, 3, (2, 9, 12), 24, 5),     # and of the head output's gradient
], ids=str)
def test_kpn_apply_gradients_match_the_custom_vjp_backward(k, c, hw, stack, slot):
    """KpnApply's gradients through autograd on the CPU: d_w comes back
    in the head's (N,H,W,k²) layout, contiguous, as the softmax's backward
    takes it; with a slot view the signal's gradient fills only its
    channels."""
    n, h, w = hw
    rng = np.random.default_rng(k * 100 + c * 10 + slot + h)
    signal = rng.random((n, h, w, stack or c)).astype(np.float32)
    grad = rng.standard_normal((n, h, w, stack or c)).astype(np.float32)
    weights = np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((n, h, w, k * k)).astype(np.float32)), axis=-1))
    ch = slice(c * slot, c * (slot + 1))
    want_n, want_w = kpn_pallas._kpn_pallas_bwd(
        k, True, (jnp.asarray(signal[..., ch]), jnp.asarray(weights)), jnp.asarray(grad[..., ch]))
    x = torch.from_numpy(signal).requires_grad_()
    wt = torch.from_numpy(weights).requires_grad_()
    out = kpn_apply.apply_per_pixel_kernels(x[..., ch], wt, k)
    d_x, d_w = torch.autograd.grad(out, (x, wt), grad_outputs=torch.from_numpy(grad)[..., ch])
    assert tuple(d_w.shape) == (n, h, w, k * k) and d_w.is_contiguous()
    np.testing.assert_allclose(d_w.numpy(), np.asarray(want_w), atol=ATOL)
    np.testing.assert_allclose(d_x[..., ch].numpy(), np.asarray(want_n), atol=ATOL)
    assert int(torch.count_nonzero(d_x)) == int(torch.count_nonzero(d_x[..., ch]))


def _random_params(init, *args, seed):
    """A parameter tree with the structure `init` gives (traced with
    jax.eval_shape), filled with seeded numpy values: fan-in-scaled conv
    kernels, small biases and temperatures."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def fill(leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@pytest.mark.parametrize("logit_norm", [True, False])
@pytest.mark.parametrize("k", [3, 5])
def test_two_slot_kpn_parameter_gradients_match_jax(k, logit_norm):
    """A group-mode KPN model (14 -> 6 channels, 2 slots: the `kpn`
    preset's head on a narrow UNet), fp32 on the CPU, parameters carried
    across by weights_io: every parameter's gradient of sum(out * cot),
    through KpnApply's backward and the head's softmax, against jax.grad
    of the JAX model."""
    kw = dict(backbone="unet", in_channels=14, out_channels=6, base_width=8, depth=2,
              kernel_prediction=True, kpn_size=k, kpn_slots=2, kpn_logit_norm=logit_norm,
              act="leaky_relu")
    rng = np.random.default_rng(30 + k)
    x = rng.random((2, 24, 40, 14)).astype(np.float32)
    cot = rng.standard_normal((2, 24, 40, 6)).astype(np.float32)
    jmodel = jfactory.build_model(jfactory.ModelConfig(**kw))
    params = _random_params(jmodel.init, jnp.asarray(x), seed=k)

    def loss(p):
        return jnp.sum(jmodel.apply(p, jnp.asarray(x)) * jnp.asarray(cot))

    want = weights_io.flatten(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    model = factory.build_model(factory.ModelConfig(**kw))
    weights_io.load_into(model, params)
    (model(torch.from_numpy(x)) * torch.from_numpy(cot)).sum().backward()
    got = weights_io.flatten(weights_io.params_from_state_dict(
        {name: p.grad for name, p in model.named_parameters()}))
    assert set(got) == set(want) and any("kernel_temp" in key for key in got) == logit_norm
    for key, ref in want.items():
        err, scale = np.abs(got[key] - ref).max(), np.abs(ref).max()
        assert err <= MODEL_REL * scale, (key, err, scale)


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
