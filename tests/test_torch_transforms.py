"""The port's encode/decode, recomposition, frame padding and EXR copy
against the JAX package's, on synthetic Monte-Carlo frames made with numpy
from a seed (atol 1e-6; the EXR codecs bit-equal)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import passes as jpasses
from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu.data import exr as jexr
from deepdenoiser_tpu.data import synthetic as jsynthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.inference import tiled as jtiled
from deepdenoiser_tpu.models.factory import ModelConfig as JModelConfig
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import config, passes, transforms
from deepdenoiser_tpu_torch.data import exr, synthetic
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models.factory import ModelConfig

ATOL = 1e-6
SCALES = {"radiance": 0.7, "depth": 0.25}


@pytest.fixture(scope="module")
def noisy():
    clean = jsynthetic.generate_clean_passes(20, 28, seed=11)
    return jsynthetic.add_mc_noise(clean, spp=4, seed=12)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_pass_registry_matches_jax():
    assert passes.LIGHT_GROUPS == jpasses.LIGHT_GROUPS
    assert passes.AUX_PASSES == jpasses.AUX_PASSES
    assert passes.COMPOSITE_EXTRA == jpasses.COMPOSITE_EXTRA
    assert set(passes.REGISTRY) == set(jpasses.REGISTRY)
    for name in jpasses.REGISTRY:
        assert passes.channels(name) == jpasses.channels(name)
        assert passes.get(name).kind.value == jpasses.get(name).kind.value
    for g in jpasses.LIGHT_GROUPS:
        assert passes.group_passes(g) == jpasses.group_passes(g)


@pytest.mark.parametrize("scales", [None, SCALES], ids=["plain", "scaled"])
def test_encode_joint_inputs_matches_jax(noisy, scales):
    want = jtransforms.encode_joint_inputs(_j(noisy), scales=scales)
    got = transforms.encode_joint_inputs(_t(noisy), scales=scales)
    assert got.shape[-1] == transforms.joint_input_channels() == 41
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("scales", [None, SCALES], ids=["plain", "scaled"])
def test_decode_joint_outputs_matches_jax(noisy, scales):
    net_out = np.random.default_rng(0).uniform(-0.5, 2.0, (20, 28, 24)).astype(np.float32)
    want = jtransforms.decode_joint_outputs(jnp.asarray(net_out), _j(noisy), scales=scales)
    got = transforms.decode_joint_outputs(torch.from_numpy(net_out), _t(noisy), scales=scales)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=1e-6)


def test_decode_inverts_encode(noisy):
    enc = transforms.encode_joint_inputs(_t(noisy))
    sig = torch.cat([enc[..., 9 * g : 9 * g + 6] for g in range(4)], -1)
    dec = transforms.decode_joint_outputs(sig, _t(noisy))
    for name, v in dec.items():
        np.testing.assert_allclose(v.numpy(), np.maximum(noisy[name], 0), rtol=1e-4, atol=1e-5)


def test_recompose_matches_jax(noisy):
    want = jtransforms.recompose(_j(noisy))
    got = transforms.recompose(_t(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    partial = {k: v for k, v in noisy.items() if not k.startswith("glossy")}
    np.testing.assert_allclose(
        transforms.recompose(_t(partial)).numpy(),
        np.asarray(jtransforms.recompose(_j(partial))), atol=ATOL,
    )


@pytest.mark.parametrize("name", ["diffuse_direct", "diffuse_color", "normal", "depth", "alpha"])
def test_normalize_denormalize_match_jax(noisy, name):
    x = noisy[name] * 1.5 - 0.2  # reach outside each kind's clamp range
    y = transforms.normalize(name, torch.from_numpy(x), scale=0.5)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jtransforms.normalize(name, jnp.asarray(x), scale=0.5)), atol=ATOL
    )
    np.testing.assert_allclose(
        transforms.denormalize(name, y, scale=0.5).numpy(),
        np.asarray(jtransforms.denormalize(name, jnp.asarray(y.numpy()), scale=0.5)),
        atol=ATOL, rtol=1e-6,
    )


@pytest.mark.parametrize("remod", [True, False])
def test_demodulate_remodulate_match_jax(noisy, remod):
    f_t = transforms.remodulate if remod else transforms.demodulate
    f_j = jtransforms.remodulate if remod else jtransforms.demodulate
    r, a = noisy["glossy_direct"], noisy["glossy_color"]
    np.testing.assert_allclose(
        f_t(torch.from_numpy(r), torch.from_numpy(a)).numpy(),
        np.asarray(f_j(jnp.asarray(r), jnp.asarray(a))), atol=ATOL, rtol=1e-6,
    )


@pytest.mark.parametrize(
    "hw,halo,multiple", [((20, 28), 8, 8), ((20, 28), 32, 8), ((37, 53), 4, 4)],
    ids=["reflect", "edge", "ragged"],
)
def test_pad_plane_and_crop_match_jax(noisy, hw, halo, multiple):
    h, w = hw
    frame = np.random.default_rng(h).standard_normal((h, w, 41)).astype(np.float32)
    jgrid = jtiled.plan_grid(h, w, 0, halo, multiple)
    grid = tiled.plan_grid(h, w, 0, halo, multiple)
    assert (grid.tile_h, grid.tile_w, grid.halo, grid.rows, grid.cols) == (
        jgrid.tile_h, jgrid.tile_w, jgrid.halo, jgrid.rows, jgrid.cols
    )
    want = jtiled.pad_plane(jnp.asarray(frame), jgrid)
    got = tiled.pad_plane(torch.from_numpy(frame), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    crop = tiled.whole_frame_reference(lambda x: x * 2, torch.from_numpy(frame), grid)
    np.testing.assert_allclose(crop.numpy(), 2 * frame, atol=ATOL)


@pytest.mark.parametrize(
    "hw,tile,halo,multiple,mode",
    [((20, 28), 0, 8, 8, "reflect"), ((20, 28), 0, 32, 8, "replicate"),
     ((37, 53), 0, 4, 4, "reflect"), ((37, 53), 16, 4, 4, "reflect"),
     ((37, 53), 16, 40, 8, "replicate")],
    ids=["reflect", "edge", "ragged", "tiled", "tiled-edge"],
)
def test_plane_pads_are_the_border_pad_plane_and_jax_apply(hw, tile, halo, multiple, mode):
    """tiled.plane_pads, the one rule of the plane's border that pad_plane and
    the joint encode kernel share: the JAX package's pads and mode
    (np.pad's reflect is PyTorch's, the edge pixel not repeated; edge is
    replicate)."""
    h, w = hw
    frame = np.random.default_rng(h + tile).standard_normal((h, w, 5)).astype(np.float32)
    grid = tiled.plan_grid(h, w, tile, halo, multiple)
    top, bottom, left, right, got_mode = tiled.plane_pads(grid)
    assert got_mode == mode
    want = np.pad(frame, ((top, bottom), (left, right), (0, 0)),
                  mode="reflect" if mode == "reflect" else "edge")
    assert want.shape[:2] == tiled.plane_hw(grid)
    np.testing.assert_array_equal(tiled.pad_plane(torch.from_numpy(frame), grid).numpy(), want)
    jgrid = jtiled.plan_grid(h, w, tile, halo, multiple)
    np.testing.assert_array_equal(np.asarray(jtiled.pad_plane(jnp.asarray(frame), jgrid)), want)


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-hq"])
@pytest.mark.parametrize("hw", [(1080, 1920), (64, 96), (2160, 3840)])
def test_plan_for_matches_jax(preset, hw):
    jcfg = _validate_channels(jconfig.PRESETS[preset])
    cfg = config.validate_channels(config.PRESETS[preset])
    assert (cfg.model.in_channels, cfg.model.out_channels) == (41, 24)
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    jg = jpipeline.plan_for(jcfg.model, jcfg.infer, *hw)
    g = pipeline.plan_for(cfg.model, cfg.infer, *hw)
    assert (g.net_h, g.net_w, g.halo) == (jg.net_h, jg.net_w, jg.halo)


def test_inference_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(config.InferenceConfig)] == [
        f.name for f in dataclasses.fields(jconfig.InferenceConfig)
    ]
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(JModelConfig)
    ]
    jdata = {f.name: f.default for f in dataclasses.fields(jconfig.DataConfig)}
    for f in dataclasses.fields(config.DataConfig):
        assert f.default == jdata[f.name], f.name
    assert config.PRESETS["kpn-hq"].infer == config.InferenceConfig(
        **dataclasses.asdict(jconfig.PRESETS["kpn-hq"].infer)
    )


def test_synthetic_copy_gives_the_same_frames():
    clean_j = jsynthetic.generate_clean_passes(24, 40, seed=3)
    clean_t = synthetic.generate_clean_passes(24, 40, seed=3)
    noisy_j = jsynthetic.add_mc_noise(clean_j, spp=4, seed=1)
    noisy_t = synthetic.add_mc_noise(clean_t, spp=4, seed=1)
    for a, b in ((clean_j, clean_t), (noisy_j, noisy_t)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_exr_copy_is_bit_equal_to_jax_codec(noisy, tmp_path, writer):
    """Write with one package, read with the other: float passes come back
    bit-equal, and both codecs write the same bytes."""
    w_mod, r_mod = (exr, jexr) if writer == "torch" else (jexr, exr)
    frame = {k: np.asarray(v, np.float32) for k, v in noisy.items()}
    w_mod.save_frame_dir(tmp_path / "dir", frame)
    back = r_mod.load_frame_dir(tmp_path / "dir", strict=False)
    assert set(back) == set(frame)
    for k, v in frame.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    w_mod.save_multilayer_exr(tmp_path / "ml.exr", frame)
    ml = r_mod.load_multilayer_exr(tmp_path / "ml.exr")
    for k, v in frame.items():
        np.testing.assert_array_equal(ml[k], v, err_msg=k)
    for pixel_type in ("float", "half"):
        w_mod.write_exr(tmp_path / "a.exr", frame["combined"], pixel_type=pixel_type)
        r_mod.write_exr(tmp_path / "b.exr", frame["combined"], pixel_type=pixel_type)
        assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
        np.testing.assert_array_equal(
            r_mod.read_exr(tmp_path / "a.exr"), w_mod.read_exr(tmp_path / "a.exr")
        )


# twins of tests/test_passes.py:39-61 and tests/test_transforms.py:109-114,
# each held to the JAX function


@pytest.mark.parametrize("name", ["diffuse_direct", "combined", "depth"])
def test_feature_naming_roundtrip_matches_jax(name):
    assert (passes.SOURCE, passes.TARGET, passes.PREDICTION) == (
        jpasses.SOURCE, jpasses.TARGET, jpasses.PREDICTION)
    for role, idx in [(passes.SOURCE, 0), (passes.SOURCE, 3), (passes.TARGET, 0),
                      (passes.PREDICTION, 0)]:
        key = passes.feature_name(name, role, idx)
        assert key == jpasses.feature_name(name, role, idx)
        p, r, i = passes.parse_feature_name(key)
        assert (p, r, i) == jpasses.parse_feature_name(key)
        assert p == name and r == role
        if role == passes.SOURCE:
            assert i == idx


def test_feature_name_validates_pass_and_role_as_jax_does():
    for mod in (passes, jpasses):
        with pytest.raises(KeyError):
            mod.feature_name("nonexistent")
        with pytest.raises(ValueError, match="unknown role"):
            mod.feature_name("depth", "weights")
        with pytest.raises(ValueError, match="unparseable"):
            mod.parse_feature_name("source/depth")


@pytest.mark.parametrize("kw", [
    dict(groups=("diffuse", "glossy"), use_depth=False),
    dict(),
    dict(groups=("transmission",), use_normal=False, use_alpha=False),
    dict(groups=(), use_normal=False, use_depth=False, use_alpha=False),
])
def test_feature_flags_match_jax(kw):
    ff, jff = passes.FeatureFlags(**kw), jpasses.FeatureFlags(**kw)
    assert ff.aux_passes == jff.aux_passes
    assert ff.aux_channels == jff.aux_channels
    assert ff.mask_bits() == jff.mask_bits()
    assert dataclasses.asdict(ff) == dataclasses.asdict(jff)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ff.use_depth = not ff.use_depth


def test_feature_flags_of_the_jax_test():
    ff = passes.FeatureFlags(groups=("diffuse", "glossy"), use_depth=False)
    assert ff.aux_passes == ("normal", "alpha")
    assert ff.aux_channels == 4
    assert ff.mask_bits() == (1, 1, 0, 0, 1, 0, 1)
    with pytest.raises(KeyError):
        passes.FeatureFlags(groups=("fog",))


@pytest.mark.parametrize("kw,hw", [
    (dict(groups=("diffuse",), use_depth=False), (8, 10)),
    (dict(), (3, 5)),
    (dict(groups=("glossy", "transmission"), use_alpha=False), (1, 7)),
])
def test_flag_channels_match_jax(kw, hw):
    ff, jff = passes.FeatureFlags(**kw), jpasses.FeatureFlags(**kw)
    ch = transforms.encode_flag_channels(ff, *hw)
    ref = np.asarray(jtransforms.encode_flag_channels(jff, *hw))
    assert ch.dtype == torch.float32 and tuple(ch.shape) == ref.shape == (*hw, 7)
    np.testing.assert_array_equal(ch.numpy(), ref)
    np.testing.assert_array_equal(ch[0, 0].numpy(), np.asarray(ff.mask_bits(), np.float32))
    assert ch.numpy().std(axis=(0, 1)).max() == 0  # constant per channel
    assert transforms.encode_flag_channels(ff, *hw, device="cpu").device == torch.device("cpu")
