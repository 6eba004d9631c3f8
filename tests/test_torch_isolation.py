"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card or raise — there is no silent CPU path.

`deepdenoiser_tpu_torch` starts with `deepdenoiser_tpu`, so the checks match
the module name `deepdenoiser_tpu` exactly, or `deepdenoiser_tpu.` with the
dot, never a bare prefix.
"""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepdenoiser_tpu_torch import cli, config, device, weights_io
from deepdenoiser_tpu_torch.data import exr, synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepdenoiser_tpu_torch"
# the JAX stack, and what its training path uses that the card's machine
# lacks (Grain, clu, PIL)
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "orbax", "grain", "clu", "PIL"}


def _forbidden(module: str) -> bool:
    return (
        module.split(".")[0] in FORBIDDEN_TOP
        or module == "deepdenoiser_tpu"
        or module.startswith("deepdenoiser_tpu.")
    )


def test_forbidden_name_match_is_not_fooled_by_the_prefix():
    assert _forbidden("deepdenoiser_tpu") and _forbidden("deepdenoiser_tpu.models.kpn")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("grain.python") and _forbidden("PIL.Image") and _forbidden("clu")
    assert not _forbidden("deepdenoiser_tpu_torch")
    assert not _forbidden("deepdenoiser_tpu_torch.models.kpn")
    assert not _forbidden("jaxtyping_like")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules()
    assert "deepdenoiser_tpu_torch.ops.kpn_apply" in mods
    assert "deepdenoiser_tpu_torch.ops.fused_ingest" in mods
    for new in ("models.tiramisu", "models.multiscale", "inference.sequence", "inference.tiled",
                "data.prepare", "ops.metrics", "cli"):
        assert f"deepdenoiser_tpu_torch.{new}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "deepdenoiser_tpu_torch.ops.kpn_apply" in loaded
    assert "deepdenoiser_tpu_torch.ops.fused_ingest" in loaded
    # importing the port builds nothing and loads no compiler front end
    assert "triton" not in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize(
    "path",
    [*sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")), "chip_smoke.py"],
)
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """Also covers imports inside functions, which an import test can miss."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    bad = [n for n in names if _forbidden(n)]
    assert not bad, (path, bad)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")


def test_device_resolves_to_cuda_or_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve()
    assert device.resolve("cpu") == torch.device("cpu")


def test_make_joint_frame_denoiser_without_device_raises(no_card):
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, 32, 48, params)


def test_make_group_frame_denoiser_without_device_raises(no_card):
    cfg = config.validate_channels(config.PRESETS["flagship-max"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_ema_f16.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_group_frame_denoiser(cfg.model, cfg.infer, 32, 48, params)


def test_make_rgb_frame_denoiser_and_denoise_crop_without_device_raise(no_card):
    mcfg = factory.ModelConfig(in_channels=10, out_channels=3, base_width=32, depth=2,
                               convs_per_level=1, act="leaky_relu", predict_residual=True)
    params = weights_io.load_release_params(REPO / "weights" / "rgb_small_ema_f16.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_rgb_frame_denoiser(mcfg, config.InferenceConfig(), 32, 48, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.denoise_crop(mcfg, params, {})


@pytest.mark.parametrize("preset,weights", [
    ("flagship-hq", "flagship_hq_ema_f16.npz"), ("flagship-max", "kpn_ema_f16.npz"),
], ids=["joint", "group"])
def test_cli_without_device_raises(no_card, tmp_path, preset, weights):
    clean = synthetic.generate_clean_passes(16, 24, seed=0)
    exr.save_frame_dir(tmp_path / "frame", synthetic.add_mc_noise(clean, spp=4, seed=1))
    argv = ["denoise", "--preset", preset, "--weights", str(REPO / "weights" / weights),
            "--frame", str(tmp_path / "frame"), "--out", str(tmp_path / "out.exr")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not (tmp_path / "out.exr").exists()


@pytest.mark.parametrize("kw,match", [
    (dict(use_flags=True), "use_flags"),
    (dict(infer=dict(tile=64)), "tiled"),
    (dict(infer=dict(tile_batch=2)), "tiled"),
    (dict(infer=dict(stitch="feather")), "tiled"),
    (dict(infer=dict(spatial_shard=True)), "spatial"),
])
def test_later_slice_options_raise_not_implemented(kw, match):
    """Spatial sharding belongs to the multi-device slice and raises; the
    tiled options are ported and build; use_flags is ported and wants the
    flag-conditioned model's 45 input channels."""
    kw = dict(kw)
    cfg = config.validate_channels(config.PRESETS["flagship-hq"])
    infer = dataclasses.replace(cfg.infer, **kw.pop("infer", {}))
    params = weights_io.load_release_params(REPO / "weights" / "flagship_hq_ema_f16.npz")

    def make():
        return pipeline.make_joint_frame_denoiser(cfg.model, infer, 32, 48, params,
                                                  device="cpu", **kw)
    if match == "spatial":
        with pytest.raises(NotImplementedError, match="multi-device"):
            make()
        return
    den, grid = make()
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(32, 48, seed=0), spp=4, seed=1)
    if match == "use_flags":
        with pytest.raises(RuntimeError, match="channels"):  # 45 planes into a 41-channel stem
            den(noisy)
        return
    if infer.tile:  # tiled: the certified halo, not the 32 px border
        assert grid.halo >= factory.halo(cfg.model) > cfg.infer.border
    out = den(noisy)
    assert tuple(out["combined"].shape) == (32, 48, 3) and torch.isfinite(out["combined"]).all()


@pytest.mark.parametrize("factory_fn,preset,weights", [
    (pipeline.make_group_frame_denoiser, "flagship-max", "kpn_ema_f16.npz"),
    (pipeline.make_rgb_frame_denoiser, None, "rgb_small_ema_f16.npz"),
], ids=["group", "rgb"])
@pytest.mark.parametrize("infer_kw,match", [
    (dict(tile=64), "tiled"), (dict(stitch="feather"), "tiled"), (dict(spatial_shard=True), "spatial"),
], ids=["tile", "feather", "spatial"])
def test_group_and_rgb_later_slice_options_raise_not_implemented(
        factory_fn, preset, weights, infer_kw, match):
    if preset:
        mcfg = config.validate_channels(config.PRESETS[preset]).model
    else:
        mcfg = factory.ModelConfig(in_channels=10, out_channels=3, base_width=32, depth=2,
                                   convs_per_level=1, act="leaky_relu", predict_residual=True)
    infer = dataclasses.replace(config.InferenceConfig(), **infer_kw)
    params = weights_io.load_release_params(REPO / "weights" / weights)
    if match == "spatial":  # the multi-device slice's
        with pytest.raises(NotImplementedError, match="multi-device"):
            factory_fn(mcfg, infer, 32, 48, params, device="cpu")
        return
    # tiled and feathered frames are ported: they build and run
    den, grid = factory_fn(mcfg, infer, 32, 48, params, device="cpu")
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(32, 48, seed=0), spp=4, seed=1)
    out = den(noisy)
    assert tuple(out["combined"].shape) == (32, 48, 3) and torch.isfinite(out["combined"]).all()


def test_group_frame_with_a_mesh_raises_not_implemented():
    cfg = config.validate_channels(config.PRESETS["flagship-max"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_ema_f16.npz")
    with pytest.raises(NotImplementedError, match="multi-device"):
        pipeline.make_group_frame_denoiser(cfg.model, cfg.infer, 32, 48, params,
                                           device="cpu", mesh=object())
