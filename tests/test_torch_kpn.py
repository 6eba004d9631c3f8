"""The port's kernel-prediction filter apply and head against the JAX
package's.

On the CPU the wrapper (ops/kpn_apply.py) runs the plain PyTorch version and
counts no launch; it is held to kpn.apply_per_pixel_kernels and to the TPU
kernel in interpret mode at the bar of tests/test_pallas.py (atol 1e-5).
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

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
    weights = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return noisy, weights


@pytest.mark.parametrize("k", [3, 5])
def test_plain_apply_matches_jax_and_tpu_kernel(k):
    noisy, weights = _inputs(0, (2, 20, 36, 3), k)
    got = kpn.apply_per_pixel_kernels(torch.from_numpy(noisy), torch.from_numpy(weights), k)
    want_xla = jkpn.apply_per_pixel_kernels(jnp.asarray(noisy), jnp.asarray(weights), k)
    want_tpu = kpn_pallas.apply_per_pixel_kernels_pallas(
        jnp.asarray(noisy), jnp.asarray(weights), k, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_tpu), atol=ATOL)


def test_delta_identity():
    rng = np.random.default_rng(1)
    x = rng.random((1, 16, 24, 3)).astype(np.float32)
    k = 3
    w = np.zeros((1, 16, 24, k * k), np.float32)
    w[..., k * k // 2] = 1.0
    got = kpn_apply.apply_per_pixel_kernels(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-6)


@pytest.mark.parametrize("k", [3, 5])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(k):
    noisy, weights = _inputs(2, (1, 12, 20, 3), k)
    kpn_apply.reset_launches()
    got = kpn_apply.apply_per_pixel_kernels(torch.from_numpy(noisy), torch.from_numpy(weights), k)
    assert kpn_apply.launches == 0
    want = kpn.apply_per_pixel_kernels(torch.from_numpy(noisy), torch.from_numpy(weights), k)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_entry_refuses_cpu_tensors():
    """apply_cuda never falls back: a CPU tensor is an error there."""
    noisy, weights = _inputs(3, (1, 8, 8, 3), 3)
    with pytest.raises(ValueError, match="CUDA"):
        kpn_apply.apply_cuda(torch.from_numpy(noisy), torch.from_numpy(weights), 3)


class _Identity(fnn.Module):
    """Stand-in backbone: the JAX head then sees the given logits."""

    @fnn.compact
    def __call__(self, x):
        return x


@pytest.mark.parametrize("logit_norm", [True, False])
@pytest.mark.parametrize("k,n_slots", [(5, 8), (3, 2)])
def test_head_matches_jax(k, n_slots, logit_norm):
    rng = np.random.default_rng(4)
    n, h, w = 1, 10, 14
    feats = (3 * rng.standard_normal((n, h, w, n_slots * k * k))).astype(np.float32)
    signal = rng.random((n, h, w, 3 * n_slots)).astype(np.float32)
    jhead = jkpn.KernelPredictionHead(
        _Identity(), kernel_size=k, n_slots=n_slots, logit_norm=logit_norm
    )
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(signal))
    if logit_norm:  # move the temperatures off their init so each slot differs
        temps = rng.standard_normal(n_slots).astype(np.float32)
        params = {"params": {"kernel_temp": jnp.asarray(temps)}}
    want = jhead.apply(params, jnp.asarray(feats), jnp.asarray(signal))

    head = kpn.KernelPredictionHead(k, n_slots, logit_norm=logit_norm)
    if logit_norm:
        head.load_state_dict({"kernel_temp": torch.from_numpy(temps)})
    kpn_apply.reset_launches()
    got = head(torch.from_numpy(feats), torch.from_numpy(signal))
    assert kpn_apply.launches == 0
    assert got.dtype == torch.float32 and got.shape == (n, h, w, 3 * n_slots)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_head_init_temperature_matches_jax():
    k, n_slots = 5, 8
    x = jnp.zeros((1, 4, 4, n_slots * k * k))
    sig = jnp.zeros((1, 4, 4, 3 * n_slots))
    params = jkpn.KernelPredictionHead(
        _Identity(), kernel_size=k, n_slots=n_slots, logit_norm=True
    ).init(jax.random.PRNGKey(0), x, sig)
    head = kpn.KernelPredictionHead(k, n_slots, logit_norm=True)
    np.testing.assert_allclose(
        head.kernel_temp.detach().numpy(), np.asarray(params["params"]["kernel_temp"]), atol=1e-7
    )


@pytest.mark.parametrize("k", [2, 4, 7])
def test_wrapper_rejects_unsupported_kernel_sizes(k):
    with pytest.raises(ValueError, match="kernel_size"):
        kpn_apply.apply_cuda(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, k * k), k)
