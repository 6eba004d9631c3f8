"""The layout in which the KPN head hands each slot's weights to the filter
apply: a contiguous (N,H,W,k²) fp32 softmax, the taps last, as the JAX head
computes it (deepdenoiser_tpu/models/kpn.py) and as the forward kernel
(csrc/kpn_apply.cu) stages it.

The head's output against the JAX head's, forward and backward, is held by
tests/test_torch_kpn.py and tests/test_torch_kpn_grad.py.
"""

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch.models import kpn


def _recording_head(k, n_slots, logit_norm, temps=None):
    head = kpn.KernelPredictionHead(k, n_slots, logit_norm=logit_norm)
    if temps is not None:
        head.load_state_dict({"kernel_temp": torch.from_numpy(temps)})
    seen = []

    def record(noisy, weights, kernel_size):
        seen.append(weights)
        return kpn.apply_per_pixel_kernels(noisy, weights, kernel_size)

    head.filter_apply = record
    return head, seen


def _softmax_weights(feats, k, s, tau=None):
    """Slot s's softmaxed weights in numpy (float64), RMS-normed when `tau`."""
    k2 = k * k
    logits = feats[..., s * k2 : (s + 1) * k2].astype(np.float64)
    if tau is not None:
        logits = logits / np.sqrt(np.mean(logits * logits, axis=-1, keepdims=True) + 1e-8) * tau
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("logit_norm", [True, False])
@pytest.mark.parametrize("k,n_slots", [(5, 8), (3, 2)])
def test_head_hands_each_slot_contiguous_nhwc_weights(k, n_slots, logit_norm):
    rng = np.random.default_rng(11)
    n, h, w = 2, 7, 9
    feats = (3 * rng.standard_normal((n, h, w, n_slots * k * k))).astype(np.float32)
    signal = rng.random((n, h, w, 3 * n_slots)).astype(np.float32)
    temps = rng.standard_normal(n_slots).astype(np.float32) if logit_norm else None
    head, seen = _recording_head(k, n_slots, logit_norm, temps)
    head(torch.from_numpy(feats), torch.from_numpy(signal))
    assert len(seen) == n_slots
    taus = 16.0 / (1.0 + np.exp(-temps.astype(np.float64))) if logit_norm else [None] * n_slots
    for s, weights in enumerate(seen):
        assert weights.dtype == torch.float32
        assert tuple(weights.shape) == (n, h, w, k * k)
        assert weights.stride(-1) == 1 and weights.is_contiguous()
        want = _softmax_weights(feats, k, s, taus[s])
        np.testing.assert_allclose(weights.detach().numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_head_takes_the_backbones_channels_last_output(dtype):
    """The UNet's logits are an NHWC view of a channels-last NCHW conv
    output; each slot is a strided slice of it. The weights still arrive
    contiguous, and the output equals that of contiguous logits."""
    k, n_slots = 5, 8
    rng = np.random.default_rng(12)
    nchw = torch.from_numpy(
        (3 * rng.standard_normal((1, n_slots * k * k, 6, 10))).astype(np.float32)
    ).to(dtype).contiguous(memory_format=torch.channels_last)
    feats = nchw.permute(0, 2, 3, 1)
    assert feats.is_contiguous() and feats.dtype == dtype
    signal = torch.from_numpy(rng.random((1, 6, 10, 3 * n_slots)).astype(np.float32))
    head, seen = _recording_head(k, n_slots, logit_norm=True)
    got = head(feats, signal)
    assert all(wt.is_contiguous() and wt.dtype == torch.float32 for wt in seen)
    want = kpn.KernelPredictionHead(k, n_slots, logit_norm=True)(feats.float().contiguous(), signal)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
