"""The port's group and rgb modes, space-to-depth stem and JSON configs
against the JAX package's, on the CPU, from the same numpy inputs.

Tolerances are the port's parity bars: transforms atol 1e-6; space_to_depth /
depth_to_space exact; models at random parameters and the whole frames with
release weights max|Δ| <= 1e-4 x max|ref| in fp32; at bf16 (the presets'
compute dtype, which rounds at other places in the two frameworks) the
tonemapped PSNR gain over the noisy frame within 0.05 dB.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu import weights_io as jweights_io
from deepdenoiser_tpu.data import loader as jloader
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models import layers as jlayers
from deepdenoiser_tpu.models import unet as junet
from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import cli, config, transforms, weights_io
from deepdenoiser_tpu_torch.data import exr
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models import factory, layers, unet
from deepdenoiser_tpu_torch.ops import fused_ingest, kpn_apply, metrics

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
REL_TOL = 1e-4
GAIN_TOL_DB = 0.05
SCALES = [None, {"depth": 0.125, "radiance": 2.0}]
# the combined-RGB release model (tools/pretrain_flagship.py RGB_SMALL)
RGB_SMALL = dict(backbone="unet", in_channels=10, out_channels=3, base_width=32, depth=2,
                 convs_per_level=1, act="leaky_relu", compute_dtype="bfloat16",
                 predict_residual=True)


@functools.lru_cache(maxsize=None)
def _frame():
    clean = synthetic.generate_clean_passes(H, W, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=6)
    return clean, {k: np.asarray(v, dtype=np.float32) for k, v in noisy.items()}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _assert_close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (name, err, np.abs(want).max())


def _gain_jax(out, noisy, clean):
    tm = jmetrics.tonemap_for_metrics
    ref = tm(jnp.asarray(clean["combined"]))
    return float(jmetrics.psnr(tm(jnp.asarray(out)), ref)) - float(
        jmetrics.psnr(tm(jnp.asarray(noisy["combined"])), ref))


def _gain_torch(out, noisy, clean):
    tm = metrics.tonemap_for_metrics
    ref = tm(torch.from_numpy(np.asarray(clean["combined"], dtype=np.float32)))
    return float(metrics.psnr(tm(torch.as_tensor(out)), ref)) - float(
        metrics.psnr(tm(torch.from_numpy(noisy["combined"])), ref))


def _weights(name):
    return str(REPO / "weights" / name)


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scales", SCALES, ids=["unscaled", "scaled"])
@pytest.mark.parametrize("aux", [("normal", "depth", "alpha"), ("depth",)], ids=str)
def test_encode_group_inputs_matches_jax(aux, scales):
    _, noisy = _frame()
    want = jtransforms.encode_group_inputs(_jnp(noisy), "glossy", aux, scales=scales)
    got = transforms.encode_group_inputs(_torch(noisy), "glossy", aux, scales=scales)
    assert tuple(got.shape) == want.shape == (H, W, transforms.group_input_channels(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert transforms.group_input_channels(aux) == jtransforms.group_input_channels(aux)
    assert transforms.GROUP_OUTPUT_CHANNELS == jtransforms.GROUP_OUTPUT_CHANNELS


@pytest.mark.parametrize("scales", SCALES, ids=["unscaled", "scaled"])
@pytest.mark.parametrize("aux", [("normal", "depth"), ()], ids=str)
def test_encode_and_decode_rgb_match_jax(aux, scales):
    _, noisy = _frame()
    want = jtransforms.encode_rgb_inputs(_jnp(noisy), aux, scales=scales)
    got = transforms.encode_rgb_inputs(_torch(noisy), aux, scales=scales)
    assert tuple(got.shape) == want.shape == (H, W, transforms.rgb_input_channels(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert transforms.rgb_input_channels(aux) == jtransforms.rgb_input_channels(aux)
    net_out = np.random.default_rng(0).uniform(-0.5, 3.0, (H, W, 3)).astype(np.float32)
    want_dec = jtransforms.decode_rgb_outputs(jnp.asarray(net_out), scales)
    got_dec = transforms.decode_rgb_outputs(torch.from_numpy(net_out), scales)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# space-to-depth stem
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 12, 5), (1, 6, 4, 41)], ids=str)
def test_space_to_depth_and_back_match_jax_exactly(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = layers.space_to_depth(torch.from_numpy(x), 2)
    for use_conv in (True, False):  # the reference's one-hot conv and its reshape form
        want = jlayers.space_to_depth(jnp.asarray(x), 2, use_conv=use_conv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = np.random.default_rng(2).standard_normal(got.shape).astype(np.float32)
    back = layers.depth_to_space(torch.from_numpy(y), 2)
    for use_conv in (True, False):
        want = jlayers.depth_to_space(jnp.asarray(y), 2, use_conv=use_conv)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_array_equal(layers.depth_to_space(got, 2).numpy(), x)


def test_space_to_depth_is_not_pixel_unshuffle():
    """The release stem kernels assume channel (dy*2+dx)*C + c; PyTorch's
    pixel_unshuffle orders c*4 + dy*2 + dx, which would scramble them."""
    x = np.random.default_rng(3).standard_normal((1, 4, 6, 3)).astype(np.float32)
    ours = layers.space_to_depth(torch.from_numpy(x), 2)
    theirs = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not torch.equal(ours, theirs)
    c = 3
    perm = [ch * 4 + blk for blk in range(4) for ch in range(c)]
    assert torch.equal(ours, theirs[..., perm])
    with pytest.raises(ValueError, match="divisible"):
        layers.space_to_depth(torch.zeros((1, 5, 6, 3)), 2)
    with pytest.raises(ValueError, match="divisible"):
        layers.depth_to_space(torch.zeros((1, 4, 6, 6)), 2)


def _random_params(init, *args, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def fill(leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@pytest.mark.parametrize("depth", [1, 2])
def test_stride2_unet_matches_jax(depth):
    kw = dict(base_width=8, depth=depth, act="leaky_relu", stem_stride=2)
    cin, cout = 5, 6
    x = np.random.default_rng(depth).standard_normal((2, 16, 24, cin)).astype(np.float32)
    jnet = junet.UNet(junet.UNetSpec(**kw), cout)
    params = _random_params(jnet.init, jnp.asarray(x), seed=depth)
    want = jnet.apply(params, jnp.asarray(x))
    net = unet.UNet(unet.UNetSpec(**kw), cin, cout)
    weights_io.load_into(net, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        net(torch.zeros((1, 16 + 2 ** depth, 24, cin)))


MODEL_CASES = {
    "group-kpn": dict(in_channels=14, out_channels=6, kernel_prediction=True, kpn_size=5,
                      kpn_slots=2, kpn_logit_norm=True),
    "group-residual": dict(in_channels=14, out_channels=6, predict_residual=True),
    "rgb-kpn3": dict(in_channels=10, out_channels=3, kernel_prediction=True, kpn_size=3,
                     kpn_slots=1),
    "rgb-residual": dict(in_channels=10, out_channels=3, predict_residual=True,
                         convs_per_level=1),
    "joint-s2d-residual": dict(in_channels=41, out_channels=24, predict_residual=True,
                               stem_stride=2),
    "group-s2d-kpn": dict(in_channels=14, out_channels=6, kernel_prediction=True, kpn_size=3,
                          kpn_slots=2, stem_stride=2),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_denoiser_model_matches_jax_in_every_mode(case):
    kw = dict(backbone="unet", base_width=8, depth=2, act="leaky_relu", **MODEL_CASES[case])
    jcfg, cfg = jfactory.ModelConfig(**kw), factory.ModelConfig(**kw)
    x = np.random.default_rng(7).standard_normal((2, 32, 48, kw["in_channels"])).astype(np.float32)
    jmodel = jfactory.build_model(jcfg)
    params = _random_params(jmodel.init, jnp.asarray(x), seed=3)
    want = jmodel.apply(params, jnp.asarray(x))
    model = factory.build_model(cfg)
    weights_io.load_into(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_close(got.numpy(), want)
    assert factory.halo(cfg) == jfactory.halo(jcfg)
    assert factory.spatial_multiple(cfg) == jfactory.spatial_multiple(jcfg)
    assert factory.signal_indices(cfg) == jfactory.signal_indices(jcfg)


# --------------------------------------------------------------------------
# batched whole-frame apply
# --------------------------------------------------------------------------


def test_batched_whole_frame_apply_equals_frame_by_frame():
    grid = tiled.plan_grid(20, 28, 0, 5, 8)
    frames = torch.from_numpy(np.random.default_rng(0).random((3, 20, 28, 4)).astype(np.float32))
    seen = []

    def net(x):
        seen.append(tuple(x.shape))
        return x[..., :2] * 2 + x.mean(dim=(1, 2, 3), keepdim=True)

    got = tiled.make_tiled_apply(net, grid, 2, batch_dims=1)(frames)
    assert seen == [(3, grid.net_h, grid.net_w, 4)]  # one padded batch, one call
    assert tuple(got.shape) == (3, 20, 28, 2)
    for i in range(3):
        want = tiled.whole_frame_reference(net, frames[i], grid)
        torch.testing.assert_close(got[i], want, atol=0, rtol=0)
    torch.testing.assert_close(tiled.pad_plane(frames, grid)[1], tiled.pad_plane(frames[1], grid),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="channels"):
        tiled.make_tiled_apply(net, grid, 3, batch_dims=1)(frames)
    with pytest.raises(NotImplementedError, match="tiled"):
        tiled.make_tiled_apply(net, tiled.plan_grid(20, 28, 8, 5, 8), 2)
    with pytest.raises(NotImplementedError, match="tiled"):
        tiled.make_tiled_apply(net, grid, 2, feather=True)


# --------------------------------------------------------------------------
# frames with release weights
# --------------------------------------------------------------------------


def _group_cfgs(dtype, **infer_kw):
    jcfg = _validate_channels(jconfig.PRESETS["flagship-max"])
    cfg = config.validate_channels(config.PRESETS["flagship-max"])
    jicfg = dataclasses.replace(jcfg.infer, compute_dtype=dtype)
    icfg = dataclasses.replace(cfg.infer, compute_dtype=dtype, **infer_kw)
    return jcfg, jicfg, cfg, icfg


@functools.lru_cache(maxsize=None)
def _jax_group_frame(dtype):
    jcfg, jicfg, _, _ = _group_cfgs(dtype)
    denoise, grid = jpipeline.make_group_frame_denoiser(jcfg.model, jicfg, H, W)
    params = jweights_io.load_release_params(_weights("kpn_ema_f16.npz"))
    out = denoise(params, _jnp(_frame()[1]))
    return {k: np.asarray(v) for k, v in out.items()}, grid


def _torch_group_frame(dtype, scales=None, **infer_kw):
    _, _, cfg, icfg = _group_cfgs(dtype, **infer_kw)
    params = weights_io.load_release_params(_weights("kpn_ema_f16.npz"))
    denoise, grid = pipeline.make_group_frame_denoiser(
        cfg.model, icfg, H, W, params, device="cpu", scales=scales)
    out = denoise(_torch(_frame()[1]))
    return {k: v.numpy() for k, v in out.items()}, grid, denoise


@pytest.mark.parametrize("fused", [False, True], ids=["plain-encode", "fused-encode"])
def test_group_frame_fp32_matches_jax(fused):
    want, jgrid = _jax_group_frame("float32")
    kpn_apply.reset_launches()
    fused_ingest.reset_launches()
    got, grid, denoise = _torch_group_frame("float32", use_pallas_ingest=fused)
    assert denoise.fused is fused
    assert kpn_apply.launches == 0 and sum(fused_ingest.launches.values()) == 0
    assert (grid.net_h, grid.net_w, grid.halo) == (jgrid.net_h, jgrid.net_w, jgrid.halo)
    assert set(got) == set(want)
    for name, ref in want.items():
        _assert_close(got[name], ref, name)


def test_group_frame_bf16_gain_matches_jax():
    clean, noisy = _frame()
    want, _ = _jax_group_frame("bfloat16")
    got, _, _ = _torch_group_frame("bfloat16")
    g_jax = _gain_jax(want["combined"], noisy, clean)
    g_torch = _gain_torch(got["combined"], noisy, clean)
    assert np.isfinite(got["combined"]).all()
    assert g_torch > 0.0, g_torch
    assert abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)


def test_group_frame_fused_and_plain_encode_agree_and_scales_take_the_plain_encoder():
    plain, _, _ = _torch_group_frame("float32", use_pallas_ingest=False)
    fused, _, den = _torch_group_frame("float32", use_pallas_ingest=True)
    assert den.fused
    for name, ref in plain.items():
        np.testing.assert_array_equal(fused[name], ref, err_msg=name)
    enc_plain = torch.stack([transforms.encode_group_inputs(_torch(_frame()[1]), g)
                             for g in den.groups])
    torch.testing.assert_close(den.encode(_torch(_frame()[1])), enc_plain, atol=0, rtol=0)
    # stats-driven scales: the kernels bake the unscaled transforms, so the
    # plain encoder runs even with the flag set (the JAX pipeline's rule)
    scales = {"depth": 0.125, "radiance": 2.0}
    a, _, den_a = _torch_group_frame("float32", scales=scales, use_pallas_ingest=True)
    b, _, _ = _torch_group_frame("float32", scales=scales, use_pallas_ingest=False)
    assert not den_a.fused
    np.testing.assert_array_equal(a["combined"], b["combined"])
    jcfg, jicfg, _, _ = _group_cfgs("float32")
    jden, _ = jpipeline.make_group_frame_denoiser(
        jcfg.model, dataclasses.replace(jicfg, use_pallas_ingest=True), H, W, scales=scales)
    want = jden(jweights_io.load_release_params(_weights("kpn_ema_f16.npz")), _jnp(_frame()[1]))
    _assert_close(a["combined"], want["combined"], "combined (scaled)")


@pytest.mark.parametrize("aux", [("normal", "depth"), ("alpha",)], ids=str)
def test_group_frame_with_aux_subsets_runs_the_single_kernels_path(aux):
    """aux=('normal','depth') and ('alpha',) are the frames that reach the
    depth-only and alpha-only kernels on the card; here: fused == plain."""
    _, noisy = _frame()
    mcfg = factory.ModelConfig(in_channels=transforms.group_input_channels(aux), out_channels=6,
                               base_width=8, depth=2, act="leaky_relu", kernel_prediction=True,
                               kpn_size=3, kpn_slots=2)
    torch.manual_seed(0)
    params = weights_io.params_from_state_dict(factory.build_model(mcfg).state_dict())

    def run(fused):
        icfg = config.InferenceConfig(compute_dtype="float32", use_pallas_ingest=fused)
        den, _ = pipeline.make_group_frame_denoiser(
            mcfg, icfg, H, W, params, groups=("diffuse", "glossy"), aux=aux, device="cpu")
        assert den.fused is fused
        return den(_torch(noisy))

    a, b = run(True), run(False)
    assert set(a) == set(b) and tuple(a["combined"].shape) == (H, W, 3)
    for name in b:
        torch.testing.assert_close(a[name], b[name], atol=0, rtol=0)
    assert torch.isfinite(a["combined"]).all()


def _rgb_cfgs(dtype):
    kw = dict(RGB_SMALL, compute_dtype=dtype)
    return jfactory.ModelConfig(**kw), factory.ModelConfig(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgb_frame_matches_jax(dtype):
    clean, noisy = _frame()
    jcfg, cfg = _rgb_cfgs(dtype)
    jden, jgrid = jpipeline.make_rgb_frame_denoiser(
        jcfg, jconfig.InferenceConfig(compute_dtype=dtype), H, W)
    want = jden(jweights_io.load_release_params(_weights("rgb_small_ema_f16.npz")), _jnp(noisy))
    den, grid = pipeline.make_rgb_frame_denoiser(
        cfg, config.InferenceConfig(compute_dtype=dtype), H, W,
        weights_io.load_release_params(_weights("rgb_small_ema_f16.npz")), device="cpu")
    got = den(_torch(noisy))
    assert (grid.net_h, grid.net_w, grid.halo) == (jgrid.net_h, jgrid.net_w, jgrid.halo)
    assert set(got) == set(want) == {"combined"}
    if dtype == "float32":
        _assert_close(got["combined"].numpy(), want["combined"], "combined")
    g_jax = _gain_jax(want["combined"], noisy, clean)
    g_torch = _gain_torch(got["combined"].numpy(), noisy, clean)
    assert g_torch > 0.0 and abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoise_crop_matches_jax(dtype):
    clean, noisy = _frame()
    jcfg, cfg = _rgb_cfgs(dtype)
    want = jpipeline.denoise_crop(
        jcfg, jweights_io.load_release_params(_weights("rgb_small_ema_f16.npz")), _jnp(noisy))
    got = pipeline.denoise_crop(
        cfg, weights_io.load_release_params(_weights("rgb_small_ema_f16.npz")), _torch(noisy),
        device="cpu")
    assert tuple(got.shape) == (H, W, 3)
    if dtype == "float32":
        _assert_close(got.numpy(), want, "crop")
    g_jax = _gain_jax(want, noisy, clean)
    g_torch = _gain_torch(got.numpy(), noisy, clean)
    assert g_torch > 0.0 and abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_s2d_joint_frame_matches_jax(dtype):
    clean, noisy = _frame()
    jcfg = _validate_channels(jconfig.PRESETS["flagship"])
    cfg = config.validate_channels(config.PRESETS["flagship"])
    assert cfg.model.stem_stride == 2
    jden, jgrid = jpipeline.make_joint_frame_denoiser(
        jcfg.model, dataclasses.replace(jcfg.infer, compute_dtype=dtype), H, W)
    want = jden(jweights_io.load_release_params(_weights("flagship_ema_f16.npz")), _jnp(noisy))
    den, grid = pipeline.make_joint_frame_denoiser(
        cfg.model, dataclasses.replace(cfg.infer, compute_dtype=dtype), H, W,
        weights_io.load_release_params(_weights("flagship_ema_f16.npz")), device="cpu")
    got = den(_torch(noisy))
    assert (grid.net_h, grid.net_w, grid.halo) == (jgrid.net_h, jgrid.net_w, jgrid.halo)
    assert set(got) == set(want)
    if dtype == "float32":
        for name, ref in want.items():
            _assert_close(got[name].numpy(), ref, name)
    g_jax = _gain_jax(want["combined"], noisy, clean)
    g_torch = _gain_torch(got["combined"].numpy(), noisy, clean)
    assert g_torch > 0.0 and abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)


@pytest.mark.parametrize("preset,weights", [
    ("flagship-max", "kpn_ema_f16.npz"), ("kpn", "kpn_ema_f16.npz"),
    ("flagship", "flagship_ema_f16.npz"), (None, "rgb_small_ema_f16.npz"),
], ids=["flagship-max", "kpn", "flagship", "rgb-small"])
def test_release_weights_load_without_leftover_or_missing_keys(preset, weights):
    mcfg = (config.validate_channels(config.PRESETS[preset]).model if preset
            else factory.ModelConfig(**RGB_SMALL))
    params = weights_io.load_release_params(_weights(weights))
    model = factory.build_model(mcfg)
    weights_io.load_into(model, params)  # raises on any leftover or missing key
    assert len(model.state_dict()) == len(weights_io.flatten(params["params"]))
    stem = params["params"]["UNet_0"]["ConvStack_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
    assert stem.shape[2] == mcfg.in_channels * mcfg.stem_stride ** 2
    np.testing.assert_array_equal(
        model.state_dict()["UNet_0.ConvStack_0.ConvBlock_0.Conv_0.weight"].numpy(),
        stem.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("weights", ["kpn_ema_f16.npz", "flagship_ema_f16.npz"])
def test_params_from_state_dict_inverts_the_carry_over(weights):
    params = weights_io.load_release_params(_weights(weights))
    sd = weights_io.state_dict_from_params(params)
    back = weights_io.params_from_state_dict(sd)
    flat, want = weights_io.flatten(back), weights_io.flatten(params)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    with pytest.raises(ValueError, match="unknown parameter kind"):
        weights_io.params_from_state_dict({"Conv_0.running_mean": torch.zeros(3)})


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["group", "joint", "rgb"])
@pytest.mark.parametrize("use_flags", [False, True], ids=["", "flags"])
def test_channel_counts_match_the_reference_loader(mode, use_flags):
    jdata = jconfig.DataConfig(mode=mode, use_flags=use_flags)
    data = config.DataConfig(mode=mode, use_flags=use_flags)
    if use_flags and mode != "joint":
        with pytest.raises(ValueError, match="use_flags requires mode='joint'"):
            jloader.input_channels(jdata)
        with pytest.raises(ValueError, match="use_flags requires mode='joint'"):
            config.input_channels(data)
        return
    assert config.input_channels(data) == jloader.input_channels(jdata)
    assert config.output_channels(data) == jloader.output_channels(jdata)
    for aux in [("normal",), ("depth", "alpha"), ()]:
        assert config.input_channels(data, aux) == jloader.input_channels(jdata, aux)


def test_data_and_inference_configs_keep_the_reference_fields_and_defaults():
    assert config.to_dict(config.DataConfig()) == jconfig.to_dict(jconfig.DataConfig())
    assert config.to_dict(config.InferenceConfig()) == jconfig.to_dict(jconfig.InferenceConfig())
    assert config.to_dict(factory.ModelConfig()) == jconfig.to_dict(jfactory.ModelConfig())
    with pytest.raises(ValueError, match="unknown data mode"):
        config.input_channels(config.DataConfig(mode="volume"))


@pytest.mark.parametrize("preset", sorted(config.PRESETS))
def test_reference_json_loads_in_the_port_and_round_trips(preset, tmp_path):
    """A JSON saved by the JAX package's config.save loads in the port with
    the port's preset values, saves back to the same JSON, and a JSON the
    port saves loads in the JAX package."""
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    jconfig.save(jconfig.PRESETS[preset], jpath)
    loaded = config.load(jpath)
    ours = config.PRESETS[preset]
    assert (loaded.name, loaded.model, loaded.data, loaded.infer) == (
        ours.name, ours.model, ours.data, ours.infer)
    assert loaded.train == jconfig.to_dict(jconfig.PRESETS[preset].train)
    config.save(loaded, path)
    assert json.loads(path.read_text()) == json.loads(jpath.read_text())
    config.save(ours, path)  # the port's own preset: a partial train section
    assert jconfig.load(path) == jconfig.PRESETS[preset]
    assert config.load(path) == ours


def test_config_json_refuses_unknown_keys(tmp_path):
    d = config.to_dict(config.PRESETS["flagship-max"])
    d["infer"]["use_pallas_ingest"] = True
    p = tmp_path / "c.json"
    p.write_text(json.dumps(d))
    assert config.load(p).infer.use_pallas_ingest is True
    assert config.load(p).data.groups == ("diffuse", "glossy", "subsurface", "transmission")
    d["infer"]["use_triton_ingest"] = True
    p.write_text(json.dumps(d))
    with pytest.raises(KeyError, match="use_triton_ingest"):
        config.load(p)
    with pytest.raises(KeyError, match="unknown config key 'serve'"):
        config.from_dict(config.ExperimentConfig, {"serve": {}})


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


@pytest.fixture
def frame_dir(tmp_path):
    exr.save_frame_dir(tmp_path / "frame", _frame()[1])
    return tmp_path / "frame"


def _write_config(path, preset=None, **sections):
    d = config.to_dict(config.PRESETS[preset]) if preset else config.to_dict(
        config.ExperimentConfig())
    for section, kw in sections.items():
        d[section].update(kw)
    path.write_text(json.dumps(d))
    return str(path)


def test_cli_config_runs_group_mode_with_the_fused_ingest(frame_dir, tmp_path):
    cfg_path = _write_config(tmp_path / "max.json", "flagship-max",
                             infer=dict(use_pallas_ingest=True))
    out_dir = tmp_path / "passes"
    rc = cli.main(["denoise", "--config", cfg_path, "--weights", _weights("kpn_ema_f16.npz"),
                   "--frame", str(frame_dir), "--out", str(out_dir), "--mode", "group",
                   "--passes", "--device", "cpu"])
    assert rc == 0
    got = exr.load_frame_dir(out_dir, strict=False)
    want, _, _ = _torch_group_frame("bfloat16", use_pallas_ingest=True)
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def test_cli_preset_runs_group_mode(frame_dir, tmp_path):
    out = tmp_path / "out.exr"
    rc = cli.main(["denoise", "--preset", "flagship-max", "--weights", _weights("kpn_ema_f16.npz"),
                   "--frame", str(frame_dir), "--out", str(out), "--device", "cpu"])
    assert rc == 0
    want, _, _ = _torch_group_frame("bfloat16")
    np.testing.assert_array_equal(exr.read_exr(out), want["combined"])


def test_cli_config_runs_rgb_mode(frame_dir, tmp_path):
    clean, noisy = _frame()
    cfg_path = _write_config(tmp_path / "rgb.json", model=RGB_SMALL, data=dict(mode="rgb"))
    out = tmp_path / "rgb.exr"
    rc = cli.main(["denoise", "--config", cfg_path, "--weights", _weights("rgb_small_ema_f16.npz"),
                   "--frame", str(frame_dir), "--out", str(out), "--mode", "rgb",
                   "--device", "cpu"])
    assert rc == 0
    den, _ = pipeline.make_rgb_frame_denoiser(
        factory.ModelConfig(**RGB_SMALL), config.InferenceConfig(), H, W,
        weights_io.load_release_params(_weights("rgb_small_ema_f16.npz")), device="cpu")
    got = exr.read_exr(out)
    np.testing.assert_array_equal(got, den(_torch(noisy))["combined"].numpy())
    assert _gain_torch(got, noisy, clean) > 0.0


@pytest.mark.parametrize("preset,mode,msg", [
    ("kpn-hq", "group", "needs 14 input channels"),
    ("flagship-max", "joint", "needs 41 input channels"),
    ("flagship", "rgb", "needs 10 input channels"),
])
def test_cli_mode_mismatch_returns_2(frame_dir, tmp_path, capsys, preset, mode, msg):
    rc = cli.main(["denoise", "--preset", preset, "--weights", _weights("kpn_ema_f16.npz"),
                   "--frame", str(frame_dir), "--out", str(tmp_path / "o.exr"),
                   "--mode", mode, "--device", "cpu"])
    assert rc == 2
    assert msg in capsys.readouterr().err
    assert not (tmp_path / "o.exr").exists()


def test_cli_flags_config_overridden_to_group_mode_returns_2(frame_dir, tmp_path, capsys):
    cfg_path = _write_config(tmp_path / "flags.json", "flagship", data=dict(use_flags=True))
    rc = cli.main(["denoise", "--config", cfg_path, "--weights", _weights("flagship_ema_f16.npz"),
                   "--frame", str(frame_dir), "--out", str(tmp_path / "o.exr"),
                   "--mode", "group", "--device", "cpu"])
    assert rc == 2
    assert "incompatible" in capsys.readouterr().err


@pytest.mark.parametrize("source", [[], ["--preset", "kpn-hq", "--config", "x.json"]],
                         ids=["neither", "both"])
def test_cli_needs_exactly_one_of_preset_and_config(source, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["denoise", *source, "--weights", "w.npz", "--frame", "f", "--out", "o.exr"])
    assert e.value.code == 2
    capsys.readouterr()
