"""The port's loss library against the JAX package's (deepdenoiser_tpu/ops/losses.py).

Inputs are made with numpy from a seed and given to both as numpy. The
predictions sit near their targets, as a denoiser's do, so the losses are
of order 0.1 and fp32 sums in another order stay within atol 1e-6; the
gradients are held too, which needs |x|'s derivative at 0 to be JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.ops import losses as jlosses
from deepdenoiser_tpu_torch.ops import losses

ATOL = 1e-6
KINDS = ["l1", "l2", "smape", "huber"]


def _pair(seed=0, shape=(2, 24, 28, 6), scale=0.1):
    rng = np.random.default_rng(seed)
    target = rng.random(shape).astype(np.float32) * 2.0
    pred = (target + scale * rng.standard_normal(shape)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("kind", KINDS)
def test_difference_maps_match(kind):
    pred, target = _pair(1, scale=1.0)
    pred[0, 0, 0] = target[0, 0, 0]  # exact zeros of p - t
    want = jlosses.difference(kind, jnp.asarray(pred), jnp.asarray(target))
    got = losses.difference(kind, torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_difference_matches(kind):
    pred, target = _pair(2)
    want = jlosses.gradient_difference(kind, jnp.asarray(pred), jnp.asarray(target))
    got = losses.gradient_difference(kind, torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=ATOL)


def test_spatial_gradients_pad_the_far_edge():
    x = np.random.default_rng(3).random((1, 5, 7, 2)).astype(np.float32)
    jdy, jdx = jlosses._spatial_gradients(jnp.asarray(x))
    dy, dx = losses._spatial_gradients(torch.from_numpy(x))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("gradient_kind", ["l1", "l2"])
@pytest.mark.parametrize("gradient_weight", [0.0, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_pass_loss_and_its_gradient_match(kind, gradient_weight, gradient_kind):
    pred, target = _pair(4)
    pred[1, 3, 4] = 0.0  # an exactly-zero prediction: |p|'s derivative there
    kw = dict(kind=kind, gradient_weight=gradient_weight, gradient_kind=gradient_kind)
    jcfg, cfg = jlosses.LossConfig(**kw), losses.LossConfig(**kw)
    want, jgrad = jax.value_and_grad(
        lambda p: jlosses.pass_loss(jcfg, p, jnp.asarray(target)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.pass_loss(cfg, p, torch.from_numpy(target))
    got.backward()
    assert abs(got.item() - float(want)) <= ATOL
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("mask_shape", [(2, 1, 1, 6), (2, 24, 28, 1)], ids=["per-example", "per-pixel"])
def test_masked_pass_loss_matches(mask_shape):
    pred, target = _pair(5)
    mask = (np.random.default_rng(6).random(mask_shape) > 0.4).astype(np.float32)
    cfg, jcfg = losses.LossConfig(), jlosses.LossConfig()
    want = jlosses.pass_loss(jcfg, jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = losses.pass_loss(cfg, torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(mask))
    assert abs(float(got) - float(want)) <= ATOL


def test_fully_masked_loss_is_zero_in_both():
    pred, target = _pair(7)
    mask = np.zeros((2, 1, 1, 6), np.float32)
    want = jlosses.pass_loss(jlosses.LossConfig(), jnp.asarray(pred), jnp.asarray(target),
                             jnp.asarray(mask))
    got = losses.pass_loss(losses.LossConfig(), torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(mask))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("scales", [2, 3])
def test_ms_ssim_term_matches(scales):
    rng = np.random.default_rng(8)
    target = (rng.random((2, 48, 48, 3)) * 4.0).astype(np.float32)
    pred = np.maximum(target + 0.2 * rng.standard_normal(target.shape), 0).astype(np.float32)
    kw = dict(ms_ssim_weight=0.3, ms_ssim_scales=scales)
    want = jlosses.pass_loss(jlosses.LossConfig(**kw), jnp.asarray(pred), jnp.asarray(target))
    got = losses.pass_loss(losses.LossConfig(**kw), torch.from_numpy(pred), torch.from_numpy(target))
    assert abs(float(got) - float(want)) <= ATOL


def test_multi_pass_loss_matches():
    names = ["diffuse", "glossy", "combined"]
    preds, targets, masks = {}, {}, {}
    for i, n in enumerate(names):
        preds[n], targets[n] = _pair(10 + i, shape=(2, 16, 20, 3))
    masks["glossy"] = np.array([1.0, 0.0], np.float32).reshape(2, 1, 1, 1)
    weights = {"diffuse": 2.0, "combined": 0.5}
    cfg, jcfg = losses.LossConfig(), jlosses.LossConfig()
    wtot, wper = jlosses.multi_pass_loss(
        jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in targets.items()}, weights,
        {k: jnp.asarray(v) for k, v in masks.items()})
    tot, per = losses.multi_pass_loss(
        cfg, {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()}, weights,
        {k: torch.from_numpy(v) for k, v in masks.items()})
    assert set(per) == set(wper) == set(names)
    assert abs(float(tot) - float(wtot)) <= ATOL
    for n in names:
        assert abs(float(per[n]) - float(wper[n])) <= ATOL


def test_loss_is_fp32_for_bf16_predictions():
    pred, target = _pair(12)
    got = losses.pass_loss(losses.LossConfig(), torch.from_numpy(pred).bfloat16(),
                           torch.from_numpy(target))
    assert got.dtype == torch.float32


def test_loss_config_keeps_the_reference_fields_and_defaults():
    import dataclasses

    assert dataclasses.asdict(losses.LossConfig()) == dataclasses.asdict(jlosses.LossConfig())
    with pytest.raises(ValueError):
        losses.difference("l3", torch.zeros(1), torch.zeros(1))
