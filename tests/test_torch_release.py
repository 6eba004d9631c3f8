"""The port's release tooling on the CPU: `weights_io.save_release_params`,
`tools/export_release_weights.py` and `tools/pretrain_flagship.py`, against
the JAX package's release format, recipe models and joint pipeline.

The recipe runs here are tiny (rgb-small, crop 32, batch 2, a few steps on
the CPU); on the card tests/test_torch_gpu.py runs kpn-hq through the
recipe, with and without a teacher, and exports and denoises with its
result.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import weights_io as jweights_io
from deepdenoiser_tpu.data import synthetic
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.training.loop import _validate_channels
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.config import TrainConfig
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.tools import export_release_weights, pretrain_flagship
from deepdenoiser_tpu_torch.training import train as train_lib
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]
RGB_NPZ = REPO / "weights" / "rgb_small_ema_f16.npz"
FP32_REL_TOL = 1e-4  # x max|ref| per output pass: the joint frame's parity bar
H, W = 48, 64
EXTRA_KEYS = {"model", "mode", "val_psnr", "family"}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _recipe(out, *extra):
    """A tiny recipe run on the CPU; returns run()'s summary."""
    args = pretrain_flagship.build_parser().parse_args(
        ["--model", "rgb-small", "--crop", "32", "--batch", "2", "--log-every", "1",
         "--out", str(out), "--device", "cpu", *extra])
    return pretrain_flagship.run(args)


def _checkpoint(directory):
    return CheckpointManager(directory).read_latest(map_location="cpu")


# --------------------------------------------------------------------------
# the release npz
# --------------------------------------------------------------------------


def test_save_release_params_writes_the_jax_layout(tmp_path):
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    weights_io.save_release_params(tmp_path / "port.npz", params)
    jweights_io.save_release_params(tmp_path / "jax.npz", params)
    mine, theirs = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    shipped = _npz(REPO / "weights" / "kpn_hq_ema_f16.npz")
    assert sorted(mine) == sorted(theirs) == sorted(shipped)
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype == shipped[k].dtype == np.float16, k
        assert mine[k].shape == v.shape, k
        assert mine[k].tobytes() == v.tobytes() == shipped[k].tobytes(), k  # fp16 -> fp32 -> fp16


def test_save_release_params_loads_in_jax_to_the_same_tree(tmp_path):
    model = factory.init_model(pretrain_flagship.RGB_SMALL, torch.Generator().manual_seed(3))
    params = weights_io.params_from_state_dict(model.state_dict())
    weights_io.save_release_params(tmp_path / "w.npz", params)
    loaded = jweights_io.load_release_params(tmp_path / "w.npz")
    flat, want = weights_io.flatten(loaded), weights_io.flatten(params)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert flat[k].dtype == np.float32 and flat[k].shape == v.shape
        np.testing.assert_array_equal(flat[k], v.astype(np.float16).astype(np.float32))
    assert weights_io.flatten(weights_io.load_release_params(tmp_path / "w.npz")).keys() == flat.keys()


def test_jax_joint_pipeline_on_a_saved_file_equals_the_ports(tmp_path):
    """A joint KPN (kpn-hq's head and frame path, narrow backbone) initialised
    in the port, saved as a release file, denoised by both packages in fp32."""
    jcfg = _validate_channels(jconfig.PRESETS["kpn-hq"])
    narrow = dict(base_width=8, depth=2, convs_per_level=1)
    jmodel = dataclasses.replace(jcfg.model, **narrow)
    jinfer = dataclasses.replace(jcfg.infer, compute_dtype="float32")
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    mcfg = dataclasses.replace(cfg.model, **narrow)
    icfg = dataclasses.replace(cfg.infer, compute_dtype="float32")
    model = factory.init_model(mcfg, torch.Generator().manual_seed(5))
    weights_io.save_release_params(tmp_path / "w.npz", weights_io.params_from_state_dict(
        model.state_dict()))

    clean = synthetic.generate_clean_passes(H, W, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=6)
    jden, _ = jpipeline.make_joint_frame_denoiser(jmodel, jinfer, H, W)
    want = jden(jweights_io.load_release_params(tmp_path / "w.npz"),
                {k: jnp.asarray(v) for k, v in noisy.items()})
    den, _ = pipeline.make_joint_frame_denoiser(
        mcfg, icfg, H, W, weights_io.load_release_params(tmp_path / "w.npz"), device="cpu")
    got = den({k: torch.from_numpy(v) for k, v in noisy.items()})
    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        err = np.abs(got[name].numpy() - ref).max()
        assert err <= FP32_REL_TOL * np.abs(ref).max(), (name, err)


# --------------------------------------------------------------------------
# the exporter
# --------------------------------------------------------------------------


def test_exporter_takes_the_ema_over_the_raw_parameters(tmp_path, capsys):
    _recipe(tmp_path / "run", "--steps", "2", "--val-every", "0", "--lr", "1e-2")
    state, extra = _checkpoint(tmp_path / "run")
    assert state["step"] == 2 and extra == {"model": "rgb-small", "mode": "rgb"}
    rc = export_release_weights.main(["--ckpt", str(tmp_path / "run"), "--out",
                                      str(tmp_path / "w.npz"), "--model", "rgb-small"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step 2" in out and "M params" in out and "checkpoint extra" in out
    got = weights_io.flatten(weights_io.load_release_params(tmp_path / "w.npz"))
    ema = weights_io.flatten(weights_io.params_from_state_dict(state["ema_params"]))
    raw = weights_io.flatten(weights_io.params_from_state_dict(state["params"]))
    assert sorted(got) == sorted(_npz(RGB_NPZ))
    differs = 0
    for k, v in ema.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float16).astype(np.float32))
        differs += not np.array_equal(got[k], raw[k].astype(np.float16).astype(np.float32))
    assert differs > 0  # two steps at lr 1e-2 move the raw parameters off the EMA


def test_exporter_falls_back_to_the_raw_parameters_without_an_ema(tmp_path):
    state = train_lib.create_state(pretrain_flagship.RGB_SMALL, TrainConfig(ema_decay=0.0),
                                   seed=1, device="cpu")
    CheckpointManager(tmp_path / "run").save(7, state)
    assert export_release_weights.main(["--ckpt", str(tmp_path / "run"), "--out",
                                        str(tmp_path / "w.npz"), "--model", "rgb-small"]) == 0
    got = weights_io.flatten(weights_io.load_release_params(tmp_path / "w.npz"))
    raw = weights_io.flatten(weights_io.params_from_state_dict(state.model.state_dict()))
    for k, v in raw.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float16).astype(np.float32))


def test_exporter_refuses_a_missing_checkpoint_and_a_tree_of_another_model(tmp_path, capsys):
    assert export_release_weights.main(["--ckpt", str(tmp_path / "none"), "--out",
                                        str(tmp_path / "w.npz")]) == 1
    assert "no checkpoint under" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()
    state = train_lib.create_state(pretrain_flagship.RGB_SMALL, TrainConfig(ema_decay=0.9),
                                   seed=1, device="cpu")
    CheckpointManager(tmp_path / "run").save(1, state)
    with pytest.raises(KeyError, match="does not fit"):
        export_release_weights.main(["--ckpt", str(tmp_path / "run"), "--out",
                                     str(tmp_path / "w.npz"), "--model", "kpn-hq"])
    assert not (tmp_path / "w.npz").exists()


# --------------------------------------------------------------------------
# the recipe
# --------------------------------------------------------------------------


def test_recipe_models_equal_the_jax_recipes_field_by_field():
    from tools.pretrain_flagship import MODELS

    assert sorted(pretrain_flagship.MODELS) == sorted(MODELS)
    for name, jcfg in MODELS.items():
        assert dataclasses.asdict(pretrain_flagship.MODELS[name]) == dataclasses.asdict(jcfg), name


def test_recipe_arguments_and_train_config_are_the_jax_recipes():
    args = pretrain_flagship.build_parser().parse_args([])
    assert (args.steps, args.batch, args.crop, args.lr, args.out, args.log_every, args.loss,
            args.grad_weight, args.model, args.family, args.val_every, args.teacher,
            args.distill_weight, args.init_from, args.save_every) == (
        3000, 16, 96, 5e-4, "checkpoints/flagship", 200, "l1", 0.2, "flagship", "mixed", 2000,
        None, 0.5, None, 0)
    tcfg = pretrain_flagship.train_config(pretrain_flagship.build_parser().parse_args(
        ["--steps", "500", "--model", "multiscale", "--teacher", "tiramisu"]))
    assert (tcfg.steps, tcfg.warmup_steps, tcfg.learning_rate, tcfg.schedule, tcfg.ema_decay,
            tcfg.loss.kind, tcfg.loss.gradient_weight, tcfg.scale_supervision_weight,
            tcfg.distill_weight) == (500, 50, 5e-4, "cosine", 0.999, "l1", 0.2, 0.5, 0.5)
    assert pretrain_flagship.train_config(
        pretrain_flagship.build_parser().parse_args([])).distill_weight == 0.0


def test_recipe_writes_its_checkpoints_and_the_best_and_resumes(tmp_path):
    out = tmp_path / "run"
    res = _recipe(out, "--steps", "3", "--val-every", "2")
    assert res["start"] == 0 and [v["step"] for v in res["val"]] == [2, 3]
    assert [r["step"] for r in res["log"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["ms_per_step"] > 0 for r in res["log"])
    assert CheckpointManager(out).steps() == [3]
    best_step = max(res["val"], key=lambda v: v["psnr_encoded"])["step"]
    assert CheckpointManager(f"{out}-best").steps() == [best_step]
    state, extra = _checkpoint(f"{out}-best")
    assert set(extra) == EXTRA_KEYS and extra["model"] == "rgb-small" and extra["mode"] == "rgb"
    assert extra["family"] == "mixed" and extra["val_psnr"] == res["best_psnr"]
    assert state["step"] == best_step
    assert json.loads((out / "3" / "extra.json").read_text()) == {"model": "rgb-small",
                                                                   "mode": "rgb"}

    again = _recipe(out, "--steps", "5", "--val-every", "2")
    assert again["start"] == 3 and [r["step"] for r in again["log"]] == [4, 5]
    assert CheckpointManager(out).steps() == [5]
    assert _checkpoint(out)[0]["step"] == 5


def test_recipe_honours_init_from_and_copies_it_as_the_ema(tmp_path):
    _recipe(tmp_path / "run", "--steps", "0", "--init-from", str(RGB_NPZ))
    state, _ = _checkpoint(tmp_path / "run")
    want = weights_io.flatten(weights_io.load_release_params(RGB_NPZ))
    for which in ("params", "ema_params"):
        got = weights_io.flatten(weights_io.params_from_state_dict(state[which]))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


def test_recipe_with_a_teacher_blends_its_prediction_into_the_loss(tmp_path):
    """Student and teacher both start from the rgb-small release: the
    teacher's prediction equals the student's, so its share of the L1 +
    gradient loss is 0 and the first step's loss is (1 - 0.5) x the same
    step's loss without a teacher, on the same batch."""
    init = ["--steps", "3", "--val-every", "2", "--init-from", str(RGB_NPZ)]
    plain = _recipe(tmp_path / "plain", *init)
    taught = _recipe(tmp_path / "taught", *init, "--teacher", "rgb-small")
    first_plain, first_taught = plain["log"][0]["loss"], taught["log"][0]["loss"]
    assert first_taught == pytest.approx(0.5 * first_plain, rel=1e-5)
    assert set(_checkpoint(tmp_path / "taught-best")[1]) == EXTRA_KEYS
    assert CheckpointManager(tmp_path / "taught").steps() == [3]


def test_recipe_refuses_a_teacher_of_another_mode(tmp_path):
    with pytest.raises(SystemExit, match="teacher mode 'joint' != student mode 'rgb'"):
        _recipe(tmp_path / "run", "--steps", "1", "--teacher", "flagship-hq")


def test_recipe_without_a_device_runs_on_the_card_or_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the recipe runs on it")
    args = pretrain_flagship.build_parser().parse_args(
        ["--model", "rgb-small", "--steps", "1", "--out", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_flagship.run(args)
