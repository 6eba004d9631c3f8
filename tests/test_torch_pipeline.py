"""The PyTorch port's joint-mode frame denoise against the JAX package's,
with the release weights, on the CPU.

Both packages denoise the same 64x96 synthetic frame (numpy, from a seed)
through make_joint_frame_denoiser: at fp32 every output pass agrees within
1e-4 x max|ref|; at bf16 (the presets' compute dtype) the tonemapped PSNR
gain over the noisy frame agrees within 0.05 dB. The port's CLI writes the
EXR its pipeline computes.
"""

import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import weights_io as jweights_io
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import cli, config, weights_io
from deepdenoiser_tpu_torch.data import exr
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.ops import kpn_apply, metrics

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
WEIGHTS = {
    "kpn-hq": "kpn_hq_ema_f16.npz",
    "flagship-hq": "flagship_hq_ema_f16.npz",
    "flagship-mc": "flagship_mc_ema_f16.npz",
}
FP32_REL_TOL = 1e-4
GAIN_TOL_DB = 0.05


@functools.lru_cache(maxsize=None)
def _frame():
    clean = synthetic.generate_clean_passes(H, W, seed=5)
    return clean, synthetic.add_mc_noise(clean, spp=4, seed=6)


@pytest.fixture
def frame():
    return _frame()


def _weights(preset):
    return str(REPO / "weights" / WEIGHTS[preset])


def _jax_run(preset, dtype, noisy):
    cfg = _validate_channels(jconfig.PRESETS[preset])
    icfg = dataclasses.replace(cfg.infer, compute_dtype=dtype)
    params = jweights_io.load_release_params(_weights(preset))
    denoise, grid = jpipeline.make_joint_frame_denoiser(
        cfg.model, icfg, H, W, groups=tuple(cfg.data.groups)
    )
    out = denoise(params, {k: jnp.asarray(v) for k, v in noisy.items()})
    return {k: np.asarray(v) for k, v in out.items()}, grid


@functools.lru_cache(maxsize=None)
def _torch_frame(preset, dtype):
    """The port's output on the module's frame, computed once per preset and
    dtype (the CLI tests compare their EXRs with it)."""
    return _torch_run(preset, dtype, _frame()[1])[0]


def _torch_run(preset, dtype, noisy):
    cfg = config.validate_channels(config.PRESETS[preset])
    icfg = dataclasses.replace(cfg.infer, compute_dtype=dtype)
    params = weights_io.load_release_params(_weights(preset))
    denoise, grid = pipeline.make_joint_frame_denoiser(
        cfg.model, icfg, H, W, params, groups=tuple(cfg.data.groups), device="cpu"
    )
    out = denoise({k: torch.from_numpy(v) for k, v in noisy.items()})
    return {k: v.numpy() for k, v in out.items()}, grid


def _gain_jax(out, noisy, clean):
    tm = jmetrics.tonemap_for_metrics
    ref = tm(jnp.asarray(clean["combined"]))
    return float(jmetrics.psnr(tm(jnp.asarray(out)), ref)) - float(
        jmetrics.psnr(tm(jnp.asarray(noisy["combined"])), ref)
    )


def _gain_torch(out, noisy, clean):
    tm = metrics.tonemap_for_metrics
    ref = tm(torch.from_numpy(clean["combined"]))
    return float(metrics.psnr(tm(torch.from_numpy(out)), ref)) - float(
        metrics.psnr(tm(torch.from_numpy(noisy["combined"])), ref)
    )


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-hq"])
def test_joint_frame_fp32_matches_jax(frame, preset):
    _, noisy = frame
    want, jgrid = _jax_run(preset, "float32", noisy)
    got, grid = _torch_run(preset, "float32", noisy)
    assert (grid.net_h, grid.net_w, grid.halo) == (jgrid.net_h, jgrid.net_w, jgrid.halo)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert got[name].shape == ref.shape, name
        err = np.abs(got[name] - ref).max()
        assert err <= FP32_REL_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-hq"])
def test_joint_frame_bf16_gain_matches_jax(frame, preset):
    clean, noisy = frame
    want, _ = _jax_run(preset, "bfloat16", noisy)
    got = _torch_frame(preset, "bfloat16")
    g_jax = _gain_jax(want["combined"], noisy, clean)
    g_torch = _gain_torch(got["combined"], noisy, clean)
    assert np.isfinite(got["combined"]).all()
    assert g_torch > 0.0, g_torch
    assert abs(g_torch - g_jax) <= GAIN_TOL_DB, (g_torch, g_jax)


@pytest.mark.parametrize("preset", sorted(WEIGHTS))
def test_release_weights_load_without_leftover_or_missing_keys(preset):
    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(_weights(preset))
    model = factory.build_model(cfg.model)
    weights_io.load_into(model, params)  # raises on any leftover or missing key
    sd = model.state_dict()
    n_leaves = len(weights_io.flatten(params["params"]))
    assert len(sd) == n_leaves
    # the carried weights are the file's, transposed HWIO -> OIHW
    k = params["params"]["UNet_0"]["ConvStack_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["UNet_0.ConvStack_0.ConvBlock_0.Conv_0.weight"].numpy(), k.transpose(3, 2, 0, 1)
    )


def test_load_into_reports_leftover_and_missing_keys():
    cfg = config.validate_channels(config.PRESETS["flagship-hq"])
    params = weights_io.load_release_params(_weights("kpn-hq"))
    with pytest.raises(KeyError, match="leftover"):
        weights_io.load_into(factory.build_model(cfg.model), params)


def test_cli_denoise_writes_the_pipeline_output(frame, tmp_path):
    _, noisy = frame
    frame_dir = tmp_path / "frame"
    exr.save_frame_dir(frame_dir, noisy)
    out_path = tmp_path / "out.exr"
    kpn_apply.reset_launches()
    rc = cli.main(["denoise", "--preset", "kpn-hq", "--weights", _weights("kpn-hq"),
                   "--frame", str(frame_dir), "--out", str(out_path),
                   "--mode", "joint", "--device", "cpu"])
    assert rc == 0
    assert kpn_apply.launches == 0  # CPU tensors take the plain apply
    np.testing.assert_array_equal(exr.read_exr(out_path), _torch_frame("kpn-hq", "bfloat16")["combined"])


def test_cli_denoise_passes_writes_every_output(frame, tmp_path):
    _, noisy = frame
    frame_dir = tmp_path / "frame"
    exr.save_frame_dir(frame_dir, noisy)
    out_dir = tmp_path / "passes"
    rc = cli.main(["denoise", "--preset", "flagship-hq", "--weights",
                   _weights("flagship-hq"), "--frame", str(frame_dir),
                   "--out", str(out_dir), "--passes", "--device", "cpu"])
    assert rc == 0
    got = exr.load_frame_dir(out_dir, strict=False)
    want = _torch_frame("flagship-hq", "bfloat16")
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
