"""Tiled inference in the PyTorch port against the JAX package's, on the CPU.

Bars: the tile grid, extract_tiles, stitch_tiles and the feather window are
bit-equal to the JAX functions (the feathered stitch atol 1e-6); inside the
port, tiled == whole-frame at atol 2e-5 for the cases of tests/test_tiled.py
(uneven sizes, batch_dims=1, advanced architectures), chunked == unchunked
and lazy == eager at 1e-6; the frame pipelines on the same tiled config
agree with the JAX pipelines within 1e-4 x max|ref| per output pass at fp32,
flag-conditioned frames included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.inference import tiled as jtiled
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import config, transforms, weights_io
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models import factory

CIN = 6
FP32_REL_TOL = 1e-4


def tiny_kw(**kw):
    d = dict(backbone="unet", in_channels=CIN, out_channels=4, base_width=4,
             depth=2, convs_per_level=1, act="elu")
    d.update(kw)
    return d


def _random_params(jcfg, seed, spatial=32):
    """The JAX model's parameter tree (shapes from jax.eval_shape, nothing
    compiled) filled with seeded numpy values."""
    rng = np.random.default_rng(seed)
    model = jfactory.build_model(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, spatial, spatial, jcfg.in_channels)))

    def fill(leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _model(seed=1, **kw):
    kw = tiny_kw(**kw)
    cfg = factory.ModelConfig(**kw)
    m = factory.spatial_multiple(cfg)
    params = _random_params(jfactory.ModelConfig(**kw), seed, spatial=4 * m)
    model = factory.build_model(cfg).eval()
    weights_io.load_into(model, params)
    return cfg, model, params


def _frame(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grids(h, w, tile, halo, multiple):
    return (jtiled.plan_grid(h, w, tile, halo, multiple),
            tiled.plan_grid(h, w, tile, halo, multiple))


# --------------------------------------------------------------------------
# the grid, the tiles and the stitches against the JAX functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,tile,halo,multiple", [
    (1080, 1920, 250, 67, 8), (2160, 3840, 512, 67, 8), (50, 70, 16, 0, 1), (40, 40, 16, 4, 1),
    (72, 56, 32, 21, 4), (33, 47, 0, 5, 8),
])
def test_plan_grid_and_its_accessors_match_jax(h, w, tile, halo, multiple):
    jg, g = _grids(h, w, tile, halo, multiple)
    assert dataclasses.asdict(g) == dataclasses.asdict(jg)
    assert (g.net_h, g.net_w, g.n_tiles, g.padded_hw) == (jg.net_h, jg.net_w, jg.n_tiles,
                                                          jg.padded_hw)
    if tile:
        assert (g.tile, g.net_size) == (jg.tile, jg.net_size)
        assert g.tile % multiple == 0 and g.halo % multiple == 0
        assert g.rows * g.tile >= h and g.cols * g.tile >= w


def test_4k_kpn_hq_plan_is_five_by_eight_tiles_of_656():
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    icfg = dataclasses.replace(cfg.infer, tile=512, tile_batch=8)
    g = pipeline.plan_for(cfg.model, icfg, 2160, 3840)
    assert factory.halo(cfg.model) == 67
    assert (g.rows, g.cols, g.halo, g.net_size, g.n_tiles) == (5, 8, 72, 656, 40)


@pytest.mark.parametrize("h,w,c,tile,halo,multiple", [
    (50, 70, 3, 16, 0, 1), (40, 40, 2, 16, 4, 1), (72, 56, 5, 32, 24, 8), (20, 90, 1, 8, 8, 8),
    (33, 47, 4, 0, 5, 8),
])
def test_extract_and_stitch_are_bit_equal_to_jax(h, w, c, tile, halo, multiple):
    jg, g = _grids(h, w, tile, halo, multiple)
    frame = _frame(0, h, w, c)
    want = np.asarray(jtiled.extract_tiles(jnp.asarray(frame), jg))
    got = tiled.extract_tiles(torch.from_numpy(frame), g)
    assert tuple(got.shape) == (g.n_tiles, g.net_h, g.net_w, c)
    np.testing.assert_array_equal(got.numpy(), want)
    outs = _frame(1, *want.shape[:3], 2)
    np.testing.assert_array_equal(
        tiled.stitch_tiles(torch.from_numpy(outs), g).numpy(),
        np.asarray(jtiled.stitch_tiles(jnp.asarray(outs), jg)))
    np.testing.assert_allclose(
        tiled.stitch_tiles_feathered(torch.from_numpy(outs), g).numpy(),
        np.asarray(jtiled.stitch_tiles_feathered(jnp.asarray(outs), jg)), atol=1e-6)


@pytest.mark.parametrize("t,hp", [(16, 4), (32, 0), (8, 8), (512, 72)])
def test_feather_window_is_bit_equal_to_jax_and_a_partition_of_unity(t, hp):
    w = tiled._feather_window(t, hp)
    np.testing.assert_array_equal(w, jtiled._feather_window(t, hp))
    if 0 < 2 * hp <= t:  # the right ramp of one tile over the left ramp of the next
        np.testing.assert_allclose(w[-2 * hp:] + w[: 2 * hp], 1.0, atol=1e-6)


def test_extract_stitch_identity():
    """With halo=0 and an identity network, extract + stitch is the identity."""
    frame = torch.from_numpy(_frame(4, 50, 70, 3))
    grid = tiled.plan_grid(50, 70, tile=16, halo=0, multiple=1)
    for kw in (dict(), dict(tile_batch=3), dict(tile_batch=7)):
        got = tiled.make_tiled_apply(lambda t: t, grid, 3, **kw)(frame)
        torch.testing.assert_close(got, frame, atol=0, rtol=0)


def test_feathered_stitch_partition_of_unity():
    """Identity network + feathered stitch reproduces the frame (the windows
    sum to 1 everywhere)."""
    frame = torch.from_numpy(_frame(5, 40, 40, 2))
    grid = tiled.plan_grid(40, 40, tile=16, halo=4, multiple=1)
    out = tiled.stitch_tiles_feathered(tiled.extract_tiles(frame, grid), grid)
    np.testing.assert_allclose(out.numpy(), frame.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# tiled == whole frame inside the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(40, 56), (96, 64)])
def test_tiled_equals_whole(hw):
    cfg, model, _ = _model()
    h, w = hw
    frame = torch.from_numpy(_frame(0, h, w, CIN))
    grid = tiled.plan_grid(h, w, 32, factory.halo(cfg), factory.spatial_multiple(cfg))
    with torch.no_grad():
        got = tiled.make_tiled_apply(model, grid, cfg.out_channels)(frame)
        want = tiled.whole_frame_reference(model, frame, grid)
    assert tuple(got.shape) == (h, w, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("tile_batch", [0, 5])
def test_tiled_batched_groups_equals_whole(tile_batch):
    cfg, model, _ = _model()
    h, w = 48, 40
    frames = torch.from_numpy(_frame(2, 3, h, w, CIN))
    grid = tiled.plan_grid(h, w, 32, factory.halo(cfg), factory.spatial_multiple(cfg))
    calls = []

    def net(t):
        calls.append(t.shape[0])
        return model(t)

    with torch.no_grad():
        got = tiled.make_tiled_apply(net, grid, cfg.out_channels, tile_batch=tile_batch,
                                     batch_dims=1)(frames)
        # 3 frames x 4 tiles: one batch of 12, or chunks of 5 with the last zero-padded
        assert calls == ([5, 5, 5] if tile_batch else [12])
        for i in range(3):
            want = tiled.whole_frame_reference(model, frames[i], grid)
            np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("tile_batch", [4, 2, 7])
def test_tile_chunking_matches_single_batch(tile_batch):
    """The memory-bounded lazy path (tiles sliced from the plane per chunk,
    the last chunk wrapping around) against all tiles at once."""
    cfg, model, _ = _model()
    h, w = 96, 96
    frame = torch.from_numpy(_frame(3, h, w, CIN))
    grid = tiled.plan_grid(h, w, 32, factory.halo(cfg), factory.spatial_multiple(cfg))
    calls = []

    def net(t):
        calls.append(tuple(t.shape))
        return model(t)

    with torch.no_grad():
        f_all = tiled.make_tiled_apply(model, grid, cfg.out_channels)
        f_chunk = tiled.make_tiled_apply(net, grid, cfg.out_channels, tile_batch=tile_batch)
        np.testing.assert_allclose(f_all(frame).numpy(), f_chunk(frame).numpy(), atol=1e-6)
    assert calls == [(tile_batch, grid.net_h, grid.net_w, CIN)] * -(-9 // tile_batch)


def test_lazy_chunks_wrap_around_and_feather_is_refused_there():
    grid = tiled.plan_grid(50, 70, tile=16, halo=8, multiple=8)  # 4 x 5 tiles
    frame = torch.from_numpy(_frame(6, 50, 70, 3))
    all_tiles = tiled.extract_tiles(frame, grid)
    seen = []

    def net(t):
        seen.append(t.clone())
        return t * 2

    got = tiled.make_tiled_apply(net, grid, 3, tile_batch=8)(frame)
    torch.testing.assert_close(got, frame * 2, atol=0, rtol=0)
    assert len(seen) == 3  # 20 tiles in chunks of 8: the last holds tiles 16..19, 0..3
    torch.testing.assert_close(torch.cat(seen, 0),
                               all_tiles[torch.arange(24) % 20], atol=0, rtol=0)
    with pytest.raises(ValueError, match="lazy-chunk"):
        tiled.make_tiled_apply(net, grid, 3, tile_batch=8, feather=True)
    # feather with batch_dims=1 chunks, or with every tile in one batch, is fine
    tiled.make_tiled_apply(net, grid, 3, tile_batch=8, batch_dims=1, feather=True)
    tiled.make_tiled_apply(net, grid, 3, tile_batch=20, feather=True)
    with pytest.raises(ValueError, match="batch_dims"):
        tiled.make_tiled_apply(net, grid, 3, batch_dims=2)
    with pytest.raises(ValueError, match="channels"):
        tiled.make_tiled_apply(net, grid, 4)(frame)
    with pytest.raises(ValueError, match="dims"):
        tiled.make_tiled_apply(net, grid, 3)(frame[None])


@pytest.mark.parametrize("kw,batch", [
    (dict(), 0), (dict(tile=16), 0), (dict(tile=16, tile_batch=4), 0),
    (dict(tile=16, tile_batch=5), 1),
], ids=["whole", "tiled", "lazy-chunks", "batched-chunks"])
def test_on_plane_runs_the_padded_plane_as_the_frame_form_does(kw, batch):
    """f.on_plane(pad_plane(frame)) is f(frame), network calls included, in
    the whole-frame, tiled, lazy-chunk and batched forms; a plane of
    another size is refused."""
    grid = tiled.plan_grid(50, 70, kw.get("tile", 0), 8, 8)
    frame = torch.from_numpy(_frame(9, *(2,) * batch, 50, 70, 3))
    calls = []

    def net(t):
        calls.append(t.shape[0])
        return t[..., :2] * 3 - 1

    f = tiled.make_tiled_apply(net, grid, 2, tile_batch=kw.get("tile_batch", 0), batch_dims=batch)
    tiled.reset_net_calls()
    want = f(frame)
    n_want, c_want = tiled.net_calls, list(calls)
    plane = tiled.pad_plane(frame, grid)
    assert tuple(plane.shape[-3:-1]) == tiled.plane_hw(grid)
    calls.clear()
    tiled.reset_net_calls()
    got = f.on_plane(plane)
    assert tiled.net_calls == n_want and calls == c_want
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(want, frame[..., :2] * 3 - 1, atol=0, rtol=0)
    with pytest.raises(ValueError, match="plane"):
        f.on_plane(plane[..., 1:, :, :])
    with pytest.raises(ValueError, match="plane"):
        f.on_plane(frame)


@pytest.mark.parametrize("kw", [
    dict(stem_stride=2),                      # the flagship's stem
    dict(n_scales=2, depth=1),                # multi-scale composition
    dict(stem_stride=2, depth=1, n_scales=2), # both
    dict(backbone="tiramisu", depth=1, layers_per_block=2,
         growth_rate=4, stem_stride=2),       # tiramisu + s2d stem
    dict(backbone="tiramisu", depth=2, layers_per_block=2, growth_rate=4,
         up_compress=6, layers_top=1),        # the tiramisu-lt1 shape, narrow
    dict(kernel_prediction=True, kpn_size=3, kpn_slots=2, out_channels=6),
], ids=["s2d", "multiscale", "s2d-multiscale", "tiramisu-s2d", "tiramisu-lt1", "kpn"])
def test_tiled_equals_whole_advanced_archs(kw):
    """Seam-free exactness for the architectures that shift the receptive-
    field accounting, eager and lazy."""
    cfg, model, _ = _model(**kw)
    h, w = 72, 56
    frame = torch.from_numpy(_frame(7, h, w, CIN))
    grid = tiled.plan_grid(h, w, 32, factory.halo(cfg), factory.spatial_multiple(cfg))
    with torch.no_grad():
        want = tiled.whole_frame_reference(model, frame, grid)
        got = tiled.make_tiled_apply(model, grid, cfg.out_channels)(frame)
        lazy = tiled.make_tiled_apply(model, grid, cfg.out_channels, tile_batch=4)(frame)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(lazy.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(n_scales=2, depth=1)], ids=["unet", "multiscale"])
def test_tiled_apply_matches_jax_tiled_apply(kw):
    cfg, model, params = _model(**kw)
    jmodel = jfactory.build_model(jfactory.ModelConfig(**tiny_kw(**kw)))
    h, w = 72, 56
    frame = _frame(8, h, w, CIN)
    halo, m = factory.halo(cfg), factory.spatial_multiple(cfg)
    jg, g = _grids(h, w, 32, halo, m)
    want = np.asarray(jtiled.make_tiled_apply(
        lambda t: jmodel.apply(params, t), jg, cfg.out_channels, tile_batch=4)(jnp.asarray(frame)))
    with torch.no_grad():
        got = tiled.make_tiled_apply(model, g, cfg.out_channels, tile_batch=4)(
            torch.from_numpy(frame)).numpy()
    assert np.abs(got - want).max() <= FP32_REL_TOL * np.abs(want).max()


# --------------------------------------------------------------------------
# the frame pipelines on tiled configs against the JAX pipelines
# --------------------------------------------------------------------------

H, W = 48, 64


def _noisy(seed, groups=jtransforms.LIGHT_GROUPS):
    clean = synthetic.generate_clean_passes(H, W, seed=seed, groups=groups)
    return synthetic.add_mc_noise(clean, spp=16, seed=seed + 1, groups=groups)


def _assert_frames_close(got, want):
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        err = np.abs(got[name].numpy() - ref).max()
        assert err <= FP32_REL_TOL * max(np.abs(ref).max(), 1e-30), (name, err)


def _pipeline_pair(mode, infer_kw, model_kw, **factory_kw):
    cin = {"joint": jtransforms.joint_input_channels() + (4 if factory_kw.get("use_flags") else 0),
           "group": jtransforms.group_input_channels(), "rgb": jtransforms.rgb_input_channels()}[mode]
    cout = {"joint": 24, "group": 6, "rgb": 3}[mode]
    kw = tiny_kw(in_channels=cin, out_channels=cout, **model_kw)
    jcfg, cfg = jfactory.ModelConfig(**kw), factory.ModelConfig(**kw)
    params = _random_params(jcfg, seed=0)
    jicfg = jconfig.InferenceConfig(compute_dtype="float32", **infer_kw)
    icfg = config.InferenceConfig(compute_dtype="float32", **infer_kw)
    jmake = getattr(jpipeline, f"make_{mode}_frame_denoiser")
    make = getattr(pipeline, f"make_{mode}_frame_denoiser")
    jden, jgrid = jmake(jcfg, jicfg, H, W, **factory_kw)
    den, grid = make(cfg, icfg, H, W, params, device="cpu", **factory_kw)
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    return (lambda frame: jden(params, {k: jnp.asarray(v) for k, v in frame.items()})), den, grid


@pytest.mark.parametrize("mode,infer_kw,model_kw", [
    ("joint", dict(tile=32), {}),
    ("joint", dict(tile=32, tile_batch=2), {}),
    ("joint", dict(tile=32, stitch="feather"), {}),
    ("joint", dict(tile=32, halo=8, stitch="feather"), {}),
    ("group", dict(tile=32), {}),
    ("group", dict(tile=32, tile_batch=3, stitch="feather"), {}),
    ("group", dict(tile=32, tile_batch=5),
     dict(kernel_prediction=True, kpn_size=3, kpn_slots=2)),
    ("rgb", dict(tile=32, tile_batch=2), {}),
    ("rgb", dict(tile=64), {}),
], ids=["joint", "joint-lazy", "joint-feather", "joint-feather-halo8", "group",
        "group-chunks-feather", "group-kpn-chunks", "rgb-lazy", "rgb-one-tile"])
def test_tiled_frame_pipelines_match_jax(mode, infer_kw, model_kw):
    jden, den, grid = _pipeline_pair(mode, infer_kw, model_kw)
    noisy = _noisy(11)
    got = den(noisy)
    _assert_frames_close(got, jden(noisy))
    assert tuple(got["combined"].shape) == (H, W, 3)
    if mode != "rgb":
        rec = transforms.recompose({k: v for k, v in got.items() if k != "combined"})
        np.testing.assert_allclose(rec.numpy(), got["combined"].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["alpha"].numpy(), noisy["alpha"])


def test_tiled_joint_frame_equals_whole_frame_with_the_certified_halo():
    """tile=32 against tile=0, border=-1: the same padded plane, so the same
    frame within the tiled bar; and feathering stays close to it."""
    kw = tiny_kw(in_channels=41, out_channels=24)
    cfg = factory.ModelConfig(**kw)
    params = _random_params(jfactory.ModelConfig(**kw), seed=0)
    noisy = _noisy(17)
    outs = {}
    for name, ikw in (("whole", dict()), ("tiled", dict(tile=32)),
                      ("lazy", dict(tile=32, tile_batch=3)),
                      ("feather", dict(tile=32, stitch="feather"))):
        den, _ = pipeline.make_joint_frame_denoiser(
            cfg, config.InferenceConfig(compute_dtype="float32", **ikw), H, W, params,
            device="cpu")
        outs[name] = den(noisy)["combined"].numpy()
    np.testing.assert_allclose(outs["tiled"], outs["whole"], atol=2e-5)
    np.testing.assert_allclose(outs["lazy"], outs["tiled"], atol=1e-6)
    diff = np.abs(outs["feather"] - outs["tiled"])
    assert diff.max() < 0.1 and diff.mean() < 2e-3, (diff.max(), diff.mean())
    with pytest.raises(ValueError, match="lazy-chunk"):
        pipeline.make_joint_frame_denoiser(
            cfg, config.InferenceConfig(tile=32, tile_batch=2, stitch="feather"), H, W, params,
            device="cpu")
    with pytest.raises(ValueError, match="stitch"):
        pipeline.make_joint_frame_denoiser(
            cfg, config.InferenceConfig(stitch="blend"), H, W, params, device="cpu")


@pytest.mark.parametrize("infer_kw", [dict(tile=0), dict(tile=32, tile_batch=2)],
                         ids=["whole", "tiled"])
def test_joint_pipeline_flags_missing_groups(infer_kw):
    """Flag-conditioned inference: a frame lacking subsurface + transmission
    goes through the same joint network — missing passes zero-filled, flag
    planes appended, absent groups dropped from the outputs and the
    recomposition — and agrees with the JAX pipeline."""
    g2 = ("diffuse", "glossy")
    noisy = _noisy(15, groups=g2)
    jden, den, _ = _pipeline_pair("joint", infer_kw, {}, use_flags=True)
    got = den(noisy)
    _assert_frames_close(got, jden(noisy))
    assert "subsurface_direct" not in got and "transmission_color" not in got
    rec = transforms.recompose({k: v for k, v in got.items() if k != "combined"}, groups=g2)
    np.testing.assert_allclose(rec.numpy(), got["combined"].numpy(), rtol=1e-5, atol=1e-5)
    # a complete frame through the same flag-conditioned denoiser
    full = _noisy(16)
    _assert_frames_close(den(full), jden(full))


@pytest.mark.parametrize("preset", sorted(config.PRESETS))
@pytest.mark.parametrize("infer_kw", [dict(tile=512, tile_batch=8), dict(tile=250),
                                      dict(tile=0, border=-1), dict(tile=256, halo=16)],
                         ids=["tile512", "tile250", "whole-certified", "halo16"])
def test_plan_for_tiled_matches_jax(preset, infer_kw):
    jcfg = _validate_channels(jconfig.PRESETS[preset])
    cfg = config.validate_channels(config.PRESETS[preset])
    for hw in ((1080, 1920), (2160, 3840)):
        jg = jpipeline.plan_for(jcfg.model, dataclasses.replace(jcfg.infer, **infer_kw), *hw)
        g = pipeline.plan_for(cfg.model, dataclasses.replace(cfg.infer, **infer_kw), *hw)
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        if infer_kw.get("tile") and not infer_kw.get("halo"):
            assert g.halo >= factory.halo(cfg.model)  # the border is ignored when tiling
