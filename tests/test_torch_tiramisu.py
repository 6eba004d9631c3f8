"""The port's tiramisu backbone, multi-scale wrapper and the models built
from them against the JAX package's, on the CPU.

Bars: forward max|Δ| <= 1e-4 x max|ref| at fp32 on narrow nets (growth 4,
2 layers per block, depth 2) with the JAX parameter tree carried across by
weights_io; the layer helpers bit-equal or atol 1e-6; rf_state, halo and
spatial_multiple equal to the JAX values for every preset; the three
tiramisu release files load with nothing missing and nothing left over, and
`tiramisu-lt1` with its release weights on a 64x64 joint frame agrees at
fp32 within 1e-4 x max|ref| per pass and at bf16 by its PSNR gain within
0.05 dB.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import weights_io as jweights_io
from deepdenoiser_tpu.data import loader as jloader
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models import layers as jlayers
from deepdenoiser_tpu.models import multiscale as jmultiscale
from deepdenoiser_tpu.models import tiramisu as jtiramisu
from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, layers, multiscale, tiramisu
from deepdenoiser_tpu_torch.ops import metrics

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4
GAIN_TOL_DB = 0.05
TIRAMISU_FILES = {"tiramisu": ("tiramisu_ema_f16.npz", 72),
                  "tiramisu-fast": ("tiramisu_fast_ema_f16.npz", 78),
                  "tiramisu-lt1": ("tiramisu_lt1_ema_f16.npz", 66)}


def _random_params(init, *args, seed):
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


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# layer helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [2, 3])
def test_nearest_upsample_and_avg_downsample_match_jax(factor):
    x = _rand(0, 2, 6 * factor, 4 * factor, 5)
    np.testing.assert_array_equal(
        layers.nearest_upsample(torch.from_numpy(x), factor).numpy(),
        np.asarray(jlayers.nearest_upsample(jnp.asarray(x), factor)))
    np.testing.assert_allclose(
        layers.avg_downsample(torch.from_numpy(x), factor).numpy(),
        np.asarray(jlayers.avg_downsample(jnp.asarray(x), factor)), atol=1e-6)
    with pytest.raises(AssertionError):
        layers.avg_downsample(torch.zeros(1, 7, 8, 1), 2)


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv_block_takes_a_tuple_as_the_channel_concat(kernel):
    """1x1 and 3x3 ConvBlocks on a tuple input == the JAX kernel-split conv."""
    a, b, c = _rand(1, 1, 10, 12, 3), _rand(2, 1, 10, 12, 5), _rand(3, 1, 10, 12, 2)
    jblock = jlayers.ConvBlock(7, kernel, act="leaky_relu")
    xs = tuple(jnp.asarray(t) for t in (a, b, c))
    params = _random_params(jblock.init, xs, seed=kernel)
    want = jblock.apply(params, xs)
    block = layers.ConvBlock(10, 7, kernel, act="leaky_relu")
    weights_io.load_into(block, params)
    with torch.no_grad():
        got = block(tuple(torch.from_numpy(t).permute(0, 3, 1, 2) for t in (a, b, c)))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want)


def test_upsample_takes_the_tiramisu_input():
    """The JAX UpSample is a sub-pixel conv from the (3,3,Cin,F) kernel; the
    port's nearest-up + conv computes the same function from that kernel,
    at the tiramisu's odd widths and for a tuple input."""
    a, b = _rand(4, 1, 6, 10, 7), _rand(5, 1, 6, 10, 6)
    jup = jlayers.UpSample(5, 3, "leaky_relu")
    xs = (jnp.asarray(a), jnp.asarray(b))
    params = _random_params(jup.init, xs, seed=4)
    want = jup.apply(params, xs)
    assert params["params"]["ConvBlock_0"]["Conv_0"]["kernel"].shape == (3, 3, 13, 5)
    up = layers.UpSample(13, 5, 3, act="leaky_relu")
    weights_io.load_into(up, params)
    with torch.no_grad():
        got = up(tuple(torch.from_numpy(t).permute(0, 3, 1, 2) for t in (a, b)))
        one = up(torch.from_numpy(np.concatenate([a, b], -1)).permute(0, 3, 1, 2))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want)
    torch.testing.assert_close(got, one, atol=0, rtol=0)


# --------------------------------------------------------------------------
# the tiramisu
# --------------------------------------------------------------------------

NARROW = dict(growth_rate=4, layers_per_block=2, depth=2, stem_width=6, act="leaky_relu")


@pytest.mark.parametrize("kw,jax_only", [
    (dict(), dict()),
    (dict(up_compress=6), dict()),
    (dict(up_compress=6, layers_top=1), dict()),
    (dict(up_compress=100), dict()),          # never exceeded: no compress conv
    (dict(stem_stride=2, layers_top=1), dict()),
    (dict(depth=3, layers_per_block=3), dict()),
    (dict(up_compress=6), dict(concat_free=True)),       # the JAX lowerings of
    (dict(layers_top=1), dict(dense_base_split=True)),   # the same function
], ids=["plain", "compress", "lt1", "compress-unused", "s2d", "deeper", "vs-concat-free",
        "vs-base-split"])
def test_tiramisu_matches_jax(kw, jax_only):
    spec_kw = {**NARROW, **kw}
    cin, cout = 7, 5
    x = _rand(6, 2, 32, 48, cin)
    jnet = jtiramisu.Tiramisu(jtiramisu.TiramisuSpec(**spec_kw, **jax_only), cout)
    params = _random_params(jnet.init, jnp.asarray(x), seed=7)
    want = jnet.apply(params, jnp.asarray(x))
    spec = tiramisu.TiramisuSpec(**spec_kw, **jax_only)
    net = tiramisu.Tiramisu(spec, cin, cout)
    weights_io.load_into(net, params)  # raises on any missing or leftover path
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)
    jspec = jtiramisu.TiramisuSpec(**spec_kw)
    js, s = jspec.rf_state(), spec.rf_state()
    assert (s.a, s.bl, s.br) == (js.a, js.bl, js.br)
    assert spec.receptive_field() == jspec.receptive_field()
    assert spec.spatial_multiple == jspec.spatial_multiple
    with pytest.raises(ValueError, match="divisible"):
        net(torch.zeros(1, 30, 48, cin))


def test_tiramisu_spec_keeps_the_reference_fields_and_defaults():
    assert dataclasses.asdict(tiramisu.TiramisuSpec()) == dataclasses.asdict(
        jtiramisu.TiramisuSpec())


@pytest.mark.parametrize("n_layers", [1, 3])
def test_dense_block_matches_jax(n_layers):
    x = _rand(8, 1, 12, 16, 6)
    jblock = jtiramisu.DenseBlock(4, n_layers, 3, "leaky_relu", jnp.float32, jnp.float32)
    params = _random_params(jblock.init, jnp.asarray(x), seed=8)
    want = jblock.apply(params, jnp.asarray(x))
    block = tiramisu.DenseBlock(6, 4, n_layers, 3, "leaky_relu")
    weights_io.load_into(block, params)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape[-1] == 4 * n_layers  # the new features only, not the input
    _assert_close(got.numpy(), want)


# --------------------------------------------------------------------------
# multi-scale
# --------------------------------------------------------------------------


def test_compose_scales_matches_jax():
    fine, coarse = _rand(9, 2, 16, 24, 3), _rand(10, 2, 8, 12, 3)
    np.testing.assert_allclose(
        multiscale.compose_scales(torch.from_numpy(fine), torch.from_numpy(coarse)).numpy(),
        np.asarray(jmultiscale.compose_scales(jnp.asarray(fine), jnp.asarray(coarse))),
        atol=1e-6)


@pytest.mark.parametrize("n_scales", [1, 2, 3])
def test_multiscale_matches_jax_with_a_shared_backbone(n_scales):
    """A backbone that is not shift-invariant across scales (it adds its
    input's mean), so a wrong pyramid or composition order shows."""
    x = _rand(11, 1, 32, 48, 4)

    def jbackbone(t):
        return t[..., :3] * 2.0 + t.mean(axis=(1, 2, 3), keepdims=True)

    def backbone(t):
        return t[..., :3] * 2.0 + t.mean(dim=(1, 2, 3), keepdim=True)

    class JWrap(jmultiscale.nn.Module):
        def __call__(self, t):
            return jbackbone(t)

    jms = jmultiscale.MultiScale(JWrap(), n_scales)
    want = jms.apply({}, jnp.asarray(x))
    want_scales = jms.apply({}, jnp.asarray(x), return_scales=True)
    ms = multiscale.MultiScale(backbone, n_scales)
    np.testing.assert_allclose(ms(torch.from_numpy(x)).numpy(), np.asarray(want), atol=1e-5)
    got_scales = ms(torch.from_numpy(x), return_scales=True)
    assert len(got_scales) == len(want_scales) == n_scales
    for s, (g, w) in enumerate(zip(got_scales, want_scales)):
        assert tuple(g.shape) == (1, 32 >> s, 48 >> s, 3)  # finest -> coarsest
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("n_scales", [1, 2, 3])
def test_multiscale_rf_algebra_matches_jax(n_scales):
    spec = factory.UNetSpec(base_width=8, depth=2)
    jspec = jfactory.UNetSpec(base_width=8, depth=2)
    s = multiscale.multiscale_rf_state(spec.rf_state, n_scales)
    js = jmultiscale.multiscale_rf_state(jspec.rf_state, n_scales)
    assert (s.a, s.bl, s.br, s.r, s.halo) == (js.a, js.bl, js.br, js.r, js.halo)
    assert multiscale.multiscale_receptive_field(37, n_scales) == (
        jmultiscale.multiscale_receptive_field(37, n_scales))
    assert multiscale.multiscale_spatial_multiple(8, n_scales) == (
        jmultiscale.multiscale_spatial_multiple(8, n_scales))


# --------------------------------------------------------------------------
# the models the factory builds
# --------------------------------------------------------------------------


def _model_kw(backbone, n_scales, kernel_prediction):
    kw = dict(backbone=backbone, in_channels=41, out_channels=24, n_scales=n_scales,
              base_width=4, depth=2, convs_per_level=1, growth_rate=4, layers_per_block=2,
              act="leaky_relu")
    if kernel_prediction:
        kw.update(kernel_prediction=True, kpn_size=3, kpn_slots=8, kpn_logit_norm=True)
    else:
        kw.update(predict_residual=True)
    return kw


@pytest.mark.parametrize("kernel_prediction", [False, True], ids=["residual", "kpn"])
@pytest.mark.parametrize("n_scales", [1, 3])
@pytest.mark.parametrize("backbone", ["unet", "tiramisu"])
def test_denoiser_model_tree_and_forward_match_jax(backbone, n_scales, kernel_prediction):
    """The Flax scope of a backbone under the multi-scale wrapper or the KPN
    head: the flattened init tree names exactly the port's state_dict keys,
    and the forward agrees."""
    kw = _model_kw(backbone, n_scales, kernel_prediction)
    jmodel = jfactory.build_model(jfactory.ModelConfig(**kw))
    model = factory.build_model(factory.ModelConfig(**kw))
    x = _rand(12, 1, 32, 48, 41)
    params = _random_params(jmodel.init, jnp.asarray(x), seed=13)
    flat = weights_io.flatten(jax.tree_util.tree_map(np.asarray, params)["params"])
    assert set(weights_io.state_dict_from_params(params)) == set(model.state_dict())
    assert len(flat) == len(model.state_dict())
    root = "UNet_0" if backbone == "unet" else "Tiramisu_0"
    assert {p.split("/")[0] for p in flat} == (
        {root, "KernelPredictionHead_0"} if kernel_prediction else {root})
    weights_io.load_into(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), jmodel.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("predict_residual", [True, False], ids=["residual", "plain"])
@pytest.mark.parametrize("backbone", ["unet", "tiramisu"])
def test_return_scales_matches_jax(backbone, predict_residual):
    kw = _model_kw(backbone, 3, False)
    kw["predict_residual"] = predict_residual
    jmodel = jfactory.build_model(jfactory.ModelConfig(**kw))
    model = factory.build_model(factory.ModelConfig(**kw))
    x = _rand(14, 1, 32, 64, 41)
    params = _random_params(jmodel.init, jnp.asarray(x), seed=15)
    weights_io.load_into(model, params)
    want = jmodel.apply(params, jnp.asarray(x), return_scales=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_scales=True)
        finest = model(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)
    torch.testing.assert_close(got[0], finest, atol=1e-6, rtol=0)
    single = factory.build_model(factory.ModelConfig(**_model_kw(backbone, 1, False)))
    with pytest.raises(AssertionError, match="multi-scale"):
        single(torch.from_numpy(x), return_scales=True)


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_every_preset_equals_the_reference_field_for_field(preset):
    assert set(config.PRESETS) == set(jconfig.PRESETS)
    ours, ref = config.PRESETS[preset], jconfig.PRESETS[preset]
    assert ours.name == ref.name
    for section in ("model", "data", "infer"):
        assert dataclasses.asdict(getattr(ours, section)) == dataclasses.asdict(
            getattr(ref, section)), section
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
    assert [f.name for f in dataclasses.fields(ours.train)] == [
        f.name for f in dataclasses.fields(ref.train)]
    # the channel counts of its data mode, flag planes included
    cfg, jcfg = config.validate_channels(ours), _validate_channels(ref)
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    assert config.input_channels(ours.data) == jloader.input_channels(ref.data)
    if preset == "flagship-flags":
        assert cfg.model.in_channels == 41 + 4


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_rf_state_halo_and_spatial_multiple_match_jax_for_every_preset(preset):
    cfg = config.validate_channels(config.PRESETS[preset]).model
    jcfg = _validate_channels(jconfig.PRESETS[preset]).model
    js, s = jfactory.rf_state(jcfg), factory.rf_state(cfg)
    assert (s.a, s.bl, s.br) == (js.a, js.bl, js.br)
    assert factory.halo(cfg) == jfactory.halo(jcfg)
    assert factory.receptive_field(cfg) == jfactory.receptive_field(jcfg)
    assert factory.spatial_multiple(cfg) == jfactory.spatial_multiple(jcfg)
    factory.build_model(cfg)  # every preset builds


# --------------------------------------------------------------------------
# release weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("preset", sorted(TIRAMISU_FILES))
def test_tiramisu_release_weights_load_without_leftover_or_missing_keys(preset):
    fname, n_arrays = TIRAMISU_FILES[preset]
    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(REPO / "weights" / fname)
    flat = weights_io.flatten(params["params"])
    assert len(flat) == n_arrays
    model = factory.build_model(cfg.model)
    weights_io.load_into(model, params)  # raises on any leftover or missing key
    sd = model.state_dict()
    assert len(sd) == n_arrays
    k = params["params"]["Tiramisu_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
    assert k.shape == (3, 3, 41, 48)
    np.testing.assert_array_equal(sd["Tiramisu_0.ConvBlock_0.Conv_0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    has_compress = any(k.startswith("Tiramisu_0.ConvBlock_4.") for k in sd)
    assert has_compress == (cfg.model.up_compress > 0)
    # the round trip back to a Flax tree is the file's tree
    back = weights_io.flatten(weights_io.params_from_state_dict(sd)["params"])
    assert set(back) == set(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


H = W = 64


@functools.lru_cache(maxsize=None)
def _frame():
    clean = synthetic.generate_clean_passes(H, W, seed=5)
    return clean, synthetic.add_mc_noise(clean, spp=4, seed=6)


def _lt1_runs(dtype):
    fname = str(REPO / "weights" / TIRAMISU_FILES["tiramisu-lt1"][0])
    _, noisy = _frame()
    jcfg = _validate_channels(jconfig.PRESETS["tiramisu-lt1"])
    jden, jgrid = jpipeline.make_joint_frame_denoiser(
        jcfg.model, dataclasses.replace(jcfg.infer, compute_dtype=dtype), H, W)
    want = jden(jweights_io.load_release_params(fname),
                {k: jnp.asarray(v) for k, v in noisy.items()})
    cfg = config.validate_channels(config.PRESETS["tiramisu-lt1"])
    den, grid = pipeline.make_joint_frame_denoiser(
        cfg.model, dataclasses.replace(cfg.infer, compute_dtype=dtype), H, W,
        weights_io.load_release_params(fname), device="cpu")
    assert (grid.net_h, grid.net_w, grid.halo) == (jgrid.net_h, jgrid.net_w, jgrid.halo)
    got = den(noisy)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


def test_tiramisu_lt1_frame_fp32_matches_jax():
    got, want = _lt1_runs("float32")
    assert set(got) == set(want)
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= REL_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_tiramisu_lt1_frame_bf16_gain_matches_jax():
    got, want = _lt1_runs("bfloat16")
    clean, noisy = _frame()
    tm, jtm = metrics.tonemap_for_metrics, jmetrics.tonemap_for_metrics
    ref = tm(torch.from_numpy(clean["combined"]))
    base = float(metrics.psnr(tm(torch.from_numpy(noisy["combined"])), ref))
    g_torch = float(metrics.psnr(tm(torch.from_numpy(got["combined"])), ref)) - base
    jref = jtm(jnp.asarray(clean["combined"]))
    g_jax = float(jmetrics.psnr(jtm(jnp.asarray(want["combined"])), jref)) - float(
        jmetrics.psnr(jtm(jnp.asarray(noisy["combined"])), jref))
    assert np.isfinite(got["combined"]).all()
    assert g_torch > 0.0, g_torch
    assert abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)
