"""The port's UNet and DenoiserModel against the JAX package's, at random
parameters and narrow widths, with the JAX parameter tree carried across
(weights_io.load_into), fp32 on the CPU: max|Δ| <= 1e-4 x max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models import layers as jlayers
from deepdenoiser_tpu.models import unet as junet
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.models import factory, layers, unet

REL_TOL = 1e-4


def _random_params(init, *args, seed):
    """A parameter tree with the structure `init` gives (traced with
    jax.eval_shape, so nothing is compiled), filled with seeded numpy
    values: fan-in-scaled conv kernels, small biases and temperatures."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def fill(leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("depth", [2, 3])
def test_unet_matches_jax(depth):
    spec = junet.UNetSpec(base_width=8, depth=depth, act="leaky_relu")
    cin, cout = 5, 7
    x = np.random.default_rng(depth).standard_normal((2, 24, 40, cin)).astype(np.float32)
    jnet = junet.UNet(spec, cout)
    params = _random_params(jnet.init, jnp.asarray(x), seed=depth)
    want = jnet.apply(params, jnp.asarray(x))

    net = unet.UNet(unet.UNetSpec(base_width=8, depth=depth, act="leaky_relu"), cin, cout)
    weights_io.load_into(net, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)


def _model_cfgs(kernel_prediction, depth):
    kw = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=depth,
              act="leaky_relu")
    if kernel_prediction:
        kw.update(kernel_prediction=True, kpn_size=5, kpn_slots=8, kpn_logit_norm=True)
    else:
        kw.update(predict_residual=True)
    return jfactory.ModelConfig(**kw), factory.ModelConfig(**kw)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("kernel_prediction", [True, False], ids=["joint_kpn", "residual"])
def test_denoiser_model_matches_jax(kernel_prediction, depth):
    jcfg, cfg = _model_cfgs(kernel_prediction, depth)
    x = np.random.default_rng(7).standard_normal((1, 32, 48, 41)).astype(np.float32)
    jmodel = jfactory.build_model(jcfg)
    params = _random_params(jmodel.init, jnp.asarray(x), seed=3)
    want = jmodel.apply(params, jnp.asarray(x))

    model = factory.build_model(cfg)
    weights_io.load_into(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), want)


def test_stride2_conv_pads_like_xla_on_even_input():
    """XLA's SAME pads a stride-2 3x3 conv (0, 1) on an even input; a port
    that padded (1, 1) would shift every output pixel by one."""
    x = np.random.default_rng(3).standard_normal((1, 16, 24, 5)).astype(np.float32)
    jdown = jlayers.DownSample(6, 3, "leaky_relu")
    params = _random_params(jdown.init, jnp.asarray(x), seed=2)
    want = np.asarray(jdown.apply(params, jnp.asarray(x)))

    down = layers.DownSample(5, 6, 3, act="leaky_relu")
    weights_io.load_into(down, params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = down(xt).permute(0, 2, 3, 1).numpy()
        conv = down.ConvBlock_0.Conv_0
        wrong = F.leaky_relu(F.conv2d(xt, conv.weight, conv.bias, stride=2, padding=1), 0.2)
    _assert_close(got, want)
    assert np.abs(wrong.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_upsample_matches_jax_subpixel_conv():
    x = np.random.default_rng(4).standard_normal((1, 6, 10, 8)).astype(np.float32)
    jup = jlayers.UpSample(4, 3, "leaky_relu")
    params = _random_params(jup.init, jnp.asarray(x), seed=4)
    want = np.asarray(jup.apply(params, jnp.asarray(x)))
    up = layers.UpSample(8, 4, 3, act="leaky_relu")
    weights_io.load_into(up, params)
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _assert_close(got, want)


@pytest.mark.parametrize("preset_kw", [
    dict(kernel_prediction=True, kpn_size=5, kpn_slots=8, kpn_logit_norm=True),
    dict(predict_residual=True),
    dict(kernel_prediction=True, kpn_size=3, kpn_slots=8, depth=2),
], ids=["kpn-hq", "flagship-hq", "kpn3-depth2"])
def test_receptive_field_and_spatial_multiple_match_jax(preset_kw):
    kw = dict(backbone="unet", in_channels=41, out_channels=24, base_width=64, depth=3,
              act="leaky_relu")
    kw.update(preset_kw)
    jcfg, cfg = jfactory.ModelConfig(**kw), factory.ModelConfig(**kw)
    js, s = jfactory.rf_state(jcfg), factory.rf_state(cfg)
    assert (s.a, s.bl, s.br) == (js.a, js.bl, js.br)
    assert factory.halo(cfg) == jfactory.halo(jcfg)
    assert factory.receptive_field(cfg) == jfactory.receptive_field(jcfg)
    assert factory.spatial_multiple(cfg) == jfactory.spatial_multiple(jcfg)
    assert factory.signal_indices(cfg) == jfactory.signal_indices(jcfg)


@pytest.mark.parametrize("kw,match", [
    (dict(backbone="tiramisu"), "tiramisu"),
    (dict(n_scales=2), "multi-scale"),
])
def test_later_slices_raise_not_implemented(kw, match):
    """The tiramisu backbone and multi-scale models, which earlier slices of
    the port refused, build now; a backbone nobody knows still raises."""
    cfg = factory.ModelConfig(in_channels=41, base_width=8, depth=2, **kw)
    model = factory.build_model(cfg)
    assert any(k.startswith("Tiramisu_0." if "tiramisu" in match else "UNet_0.")
               for k in model.state_dict())
    assert factory.spatial_multiple(cfg) == jfactory.spatial_multiple(jfactory.ModelConfig(
        in_channels=41, base_width=8, depth=2, **kw))
    with pytest.raises(ValueError, match="unknown backbone"):
        factory.build_model(factory.ModelConfig(backbone="resnet"))


@pytest.mark.parametrize("preset_kw", [
    dict(kpn_size=5, depth=3),
    dict(kpn_size=3, depth=2),
    dict(kpn_size=7, depth=1, stem_stride=2),
], ids=["k5-d3", "k3-d2", "k7-d1-s2d"])
def test_kpn_receptive_field_matches_jax(preset_kw):
    from deepdenoiser_tpu.models import kpn as jkpn
    from deepdenoiser_tpu_torch.models import kpn

    kw = dict(backbone="unet", in_channels=41, out_channels=24, base_width=64,
              act="leaky_relu", kernel_prediction=True, kpn_slots=8)
    kw.update(preset_kw)
    backbone_rf = factory.receptive_field(factory.ModelConfig(
        **{**kw, "kernel_prediction": False}))
    for rf in (backbone_rf, 1, 0, 133):
        got = kpn.kpn_receptive_field(rf, kw["kpn_size"])
        assert got == jkpn.kpn_receptive_field(rf, kw["kpn_size"])
    assert kpn.kpn_receptive_field(backbone_rf, kw["kpn_size"]) == backbone_rf + kw["kpn_size"] - 1
