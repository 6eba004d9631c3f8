"""The port's band-parallel frames (deepdenoiser_tpu_torch/parallel/halo.py)
against the JAX package's shard_map + ppermute version on an N-device CPU
mesh, on the same numpy inputs and carried-across parameters; and
spatial_shard without a mesh in all three frame modes.

The port's mesh lists the CPU n times (["cpu"] * n), as the JAX tests list
8 fake CPU devices: every band runs through the same exchange and crop.
Tolerances: the band apply atol 2e-5 (tests/test_halo.py's bar, against
JAX and against the whole frame on the same plane); the banded group
pipeline atol 3e-5 (tests/test_halo.py:51-81); the joint KPN frame and
the frames with release weights max|Δ| <= 1e-4 x max|ref| per pass in
fp32, the model parity bar.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.parallel import halo as jhalo
from deepdenoiser_tpu.parallel import mesh as jmesh
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.ops import fused_ingest, kpn_apply
from deepdenoiser_tpu_torch.parallel import halo, mesh

REPO = Path(__file__).resolve().parents[1]
CIN = 5
TINY = dict(backbone="unet", in_channels=CIN, out_channels=3, base_width=4, depth=1,
            convs_per_level=1, act="elu")  # the model of tests/test_halo.py
REL_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(mkw, params):
    m = factory.build_model(factory.ModelConfig(**mkw))
    weights_io.load_into(m, params)
    return m.eval()


def _cpu_mesh(n, axis="spatial"):
    return mesh.make_mesh(n, axis, devices=["cpu"] * n)


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in d.items()}


# ---------------------------------------------------------------------------
# plan_bands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,n,hp,m", [
    (72, 40, 2, 7, 4), (72, 40, 8, 7, 4), (100, 60, 4, 7, 4), (1080, 1920, 2, 67, 8),
    (1080, 1920, 4, 67, 8), (33, 17, 3, 5, 16), (64, 48, 4, 16, 16), (2160, 3840, 8, 131, 16),
])
def test_plan_bands_matches_jax(h, w, n, hp, m):
    grid, b = halo.plan_bands(h, w, n, hp, m)
    jgrid, jb = jhalo.plan_bands(h, w, n, hp, m)
    assert b == jb and dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    assert b % m == 0 and n * b >= h and grid.halo % m == 0 and grid.halo >= hp


def test_plan_bands_refuses_a_halo_taller_than_a_band():
    with pytest.raises(ValueError, match="band height"):
        halo.plan_bands(64, 48, 8, halo=131, multiple=16)
    with pytest.raises(ValueError, match="band height"):
        jhalo.plan_bands(64, 48, 8, halo=131, multiple=16)


def test_mesh_defaults_to_the_cards_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh holds it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(devices=["cuda:0"] * 2)


def test_mesh_refuses_more_devices_than_listed():
    with pytest.raises(ValueError, match="want 9 devices, have 8"):
        mesh.make_mesh(9, devices=["cpu"] * 8)
    m2 = mesh.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    assert m2.shape == {"data": 2, "spatial": 4} and len(m2.axis_devices("spatial")) == 4
    chunks = mesh.shard_batch({"x": np.arange(8.0)}, m2, "data")
    assert [c["x"].tolist() for c in chunks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch({"x": np.arange(6.0)}, _cpu_mesh(4, "data"), "data")


# ---------------------------------------------------------------------------
# the band apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spatial_apply_matches_jax(devices8, n_shards):
    cfg = jfactory.ModelConfig(**TINY)
    jmodel = jfactory.build_model(cfg)
    h, w = 72, 40
    frame = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (h, w, CIN)))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, CIN)))
    m, hp = jfactory.spatial_multiple(cfg), jfactory.halo(cfg)
    f = jhalo.make_spatial_apply(lambda t: jmodel.apply(params, t),
                                 jmesh.make_mesh(n_shards, axis_name="spatial"), h, w, hp, m)
    want = np.asarray(f(jnp.asarray(frame)))

    model = _port_model(TINY, _np(params))
    with torch.inference_mode():
        got = halo.make_spatial_apply(model, _cpu_mesh(n_shards), h, w, hp, m)(
            torch.from_numpy(frame))
        grid, _ = halo.plan_bands(h, w, n_shards, hp, m)
        whole = tiled.whole_frame_reference(model, torch.from_numpy(frame), grid)
    assert tuple(got.shape) == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=2e-5)


def test_spatial_apply_runs_one_replica_per_distinct_device():
    """Bands that share a device share its model; the exchange copies the
    neighbours' edge rows, so a band's input holds the plane's rows."""
    model = factory.init_model(factory.ModelConfig(**TINY), torch.Generator().manual_seed(0))
    nets = halo.replicas(model, [torch.device("cpu")] * 4)
    assert list(nets) == [torch.device("cpu")] and nets[torch.device("cpu")] is model
    seen = []

    def spy(x):
        seen.append(x.clone())
        return x[..., :3]

    h, w, n = 40, 24, 4
    frame = torch.randn(h, w, CIN, generator=torch.Generator().manual_seed(1))
    grid, b = halo.plan_bands(h, w, n, 4, 4)
    out = halo.make_spatial_apply(spy, _cpu_mesh(n), h, w, 4, 4)(frame)
    plane = tiled.pad_plane(frame, grid)
    assert len(seen) == n
    for i, x in enumerate(seen):
        torch.testing.assert_close(x[0], plane[i * b : i * b + b + 2 * grid.halo], rtol=0, atol=0)
    torch.testing.assert_close(out, frame[..., :3], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# band-parallel pipelines against the JAX package's
# ---------------------------------------------------------------------------


def _noisy(h, w, seed):
    clean = synthetic.generate_clean_passes(h, w, seed=seed)
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in synthetic.add_mc_noise(clean, spp=8, seed=3).items()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain-encode", "fused-encode"])
def test_spatial_group_pipeline_matches_jax(devices8, fused):
    """tests/test_halo.py:51-81 in both packages: 4 bands of the group frame
    against JAX's 4-device mesh and the port's own single-device frame."""
    h, w = 48, 40
    noisy = _noisy(h, w, 33)
    mkw = dict(backbone="unet", in_channels=jtransforms.group_input_channels(), out_channels=6,
               base_width=4, depth=1, convs_per_level=1, act="elu")
    jcfg = jfactory.ModelConfig(**mkw)
    params = jfactory.init_params(jcfg, jax.random.PRNGKey(0), spatial=16)
    icfg = jconfig.InferenceConfig(tile=0, compute_dtype="float32", spatial_shard=True)
    jden, jgrid = jpipeline.make_group_frame_denoiser(
        jcfg, icfg, h, w, mesh=jmesh.make_mesh(4, axis_name="spatial"))
    want = {k: np.asarray(v) for k, v in jden(params, {k: jnp.asarray(v) for k, v in noisy.items()}).items()}

    cfg = factory.ModelConfig(**mkw)
    picfg = config.InferenceConfig(tile=0, compute_dtype="float32", spatial_shard=True,
                                   use_pallas_ingest=fused)
    den, grid = pipeline.make_group_frame_denoiser(cfg, picfg, h, w, _np(params),
                                                   mesh=_cpu_mesh(4))
    whole, _ = pipeline.make_group_frame_denoiser(
        cfg, dataclasses.replace(picfg, spatial_shard=False), h, w, _np(params), device="cpu")
    got = den(_torch(noisy))
    ref = whole(_torch(noisy))
    assert grid.halo == jgrid.halo and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=3e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=3e-5, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_joint_kpn_pipeline_matches_jax(devices8, n):
    """A tiny joint KPN band-parallel: each band's head reaches the filter
    apply (the CUDA kernel's plain version here, JAX's XLA apply there), so
    n bands launch it 8 * n times on the card."""
    h, w = 64, 40
    noisy = _noisy(h, w, 7)
    mkw = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=1,
               convs_per_level=1, kernel_prediction=True, kpn_size=5, kpn_slots=8,
               kpn_logit_norm=True, act="leaky_relu")
    jcfg = jfactory.ModelConfig(**mkw)
    params = jfactory.init_params(jcfg, jax.random.PRNGKey(2), spatial=16)
    icfg = jconfig.InferenceConfig(tile=0, compute_dtype="float32", spatial_shard=True)
    jden, jgrid = jpipeline.make_joint_frame_denoiser(
        jcfg, icfg, h, w, mesh=jmesh.make_mesh(n, axis_name="spatial"))
    want = {k: np.asarray(v) for k, v in jden(params, {k: jnp.asarray(v) for k, v in noisy.items()}).items()}

    picfg = config.InferenceConfig(tile=0, compute_dtype="float32", spatial_shard=True)
    den, grid = pipeline.make_joint_frame_denoiser(factory.ModelConfig(**mkw), picfg, h, w,
                                                   _np(params), mesh=_cpu_mesh(n))
    kpn_apply.reset_launches()
    got = den(_torch(noisy))
    assert kpn_apply.launches == 0  # CPU tensors: the plain version, no launch
    assert grid.halo == jgrid.halo and set(got) == set(want)
    for k, ref in want.items():  # the model parity bar: decoded radiance reaches ~1e2
        assert np.abs(got[k].numpy() - ref).max() <= REL_TOL * np.abs(ref).max(), k


# ---------------------------------------------------------------------------
# spatial_shard without a mesh: the certified halo on one device
# ---------------------------------------------------------------------------


def _release(name):
    from deepdenoiser_tpu import weights_io as jweights_io

    return (jweights_io.load_release_params(REPO / "weights" / name),
            weights_io.load_release_params(REPO / "weights" / name))


RGB_SMALL = dict(backbone="unet", in_channels=10, out_channels=3, base_width=32, depth=2,
                 convs_per_level=1, act="leaky_relu", predict_residual=True)


@pytest.mark.parametrize("mode", ["joint", "group", "rgb"])
def test_spatial_shard_without_a_mesh_matches_jax(mode):
    """The JAX package runs spatial_shard=True with no mesh on one device
    with the certified halo (its plan_for ignores the border); so does the
    port, in every mode, at the model parity bar."""
    h, w = 32, 48
    noisy = _noisy(h, w, 11)
    if mode == "rgb":
        jm, m = jfactory.ModelConfig(**RGB_SMALL), factory.ModelConfig(**RGB_SMALL)
        jparams, params = _release("rgb_small_ema_f16.npz")
    else:
        preset, weights = (("flagship-hq", "flagship_hq_ema_f16.npz") if mode == "joint"
                           else ("flagship-max", "kpn_ema_f16.npz"))
        jm = _validate_channels(jconfig.PRESETS[preset]).model
        m = config.validate_channels(config.PRESETS[preset]).model
        jparams, params = _release(weights)
    jicfg = jconfig.InferenceConfig(compute_dtype="float32", spatial_shard=True, border=8)
    icfg = config.InferenceConfig(compute_dtype="float32", spatial_shard=True, border=8)
    jfn = {"joint": jpipeline.make_joint_frame_denoiser, "group": jpipeline.make_group_frame_denoiser,
           "rgb": jpipeline.make_rgb_frame_denoiser}[mode]
    fn = {"joint": pipeline.make_joint_frame_denoiser, "group": pipeline.make_group_frame_denoiser,
          "rgb": pipeline.make_rgb_frame_denoiser}[mode]
    jden, jgrid = jfn(jm, jicfg, h, w)
    den, grid = fn(m, icfg, h, w, params, device="cpu")
    assert grid == tiled.TileGrid(**dataclasses.asdict(jgrid))
    assert grid.halo >= factory.halo(m) > icfg.border  # the certified halo, not the border
    want = jden(jparams, {k: jnp.asarray(v) for k, v in noisy.items()})
    got = den(_torch(noisy))
    assert set(got) == set(want)
    for k, ref in want.items():
        ref = np.asarray(ref)
        assert np.abs(got[k].numpy() - ref).max() <= REL_TOL * np.abs(ref).max(), k


def test_group_frame_band_parallel_launches_the_encode_once(monkeypatch):
    """With the fused ingest the encode runs once, before the bands: the
    encode sees the whole frame and every band gets its rows of the stack."""
    calls = []
    real = fused_ingest.encode_groups_fused

    def spy(pd, groups, aux):
        out = real(pd, groups, aux)
        calls.append(tuple(out.shape))
        return out

    monkeypatch.setattr(fused_ingest, "encode_groups_fused", spy)
    h, w = 48, 40
    cfg = factory.ModelConfig(backbone="unet", in_channels=14, out_channels=6, base_width=4,
                              depth=1, convs_per_level=1)
    model = factory.init_model(cfg, torch.Generator().manual_seed(0))
    params = weights_io.params_from_state_dict(model.state_dict())
    icfg = config.InferenceConfig(compute_dtype="float32", spatial_shard=True,
                                  use_pallas_ingest=True)
    den, _ = pipeline.make_group_frame_denoiser(cfg, icfg, h, w, params, mesh=_cpu_mesh(4))
    out = den(_torch(_noisy(h, w, 5)))
    assert calls == [(4, h, w, 14)]
    assert tuple(out["combined"].shape) == (h, w, 3) and torch.isfinite(out["combined"]).all()
