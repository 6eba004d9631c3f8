"""The port's training commands end to end on the CPU, as tests/test_cli.py
drives the JAX package's: synth-data -> prepare-data -> train on a tiny
JSON -> a resumed train -> denoise and eval from the checkpoint (raw and
EMA parameters). The shards prepare-data writes are the JAX package's
(its ShardReader reads them)."""

import json

import numpy as np
import pytest

from deepdenoiser_tpu.data import shards as jshards
from deepdenoiser_tpu_torch import cli, config
from deepdenoiser_tpu_torch.data import exr
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops.losses import LossConfig

SIZE = 48


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    cfg = config.ExperimentConfig(
        name="cli-test",
        model=ModelConfig(backbone="unet", base_width=8, depth=1, convs_per_level=1),
        data=config.DataConfig(crop=32, crops_per_frame=8, batch_size=8,
                               validation_fraction=0.34, seed=1, read_threads=1),
        train=config.TrainConfig(steps=6, warmup_steps=0, learning_rate=1e-3,
                                 schedule="constant", log_every=2, eval_every=2,
                                 checkpoint_every=3, ema_decay=0.9,
                                 loss=LossConfig(gradient_weight=0.0)),
        infer=config.InferenceConfig(tile=32, compute_dtype="float32"),
    )
    config.save(cfg, ws / "config.json")
    assert cli.main(["synth-data", "--out", str(ws / "renders"), "--frames", "3",
                     "--size", str(SIZE), "--spp", "4", "--seed", "3"]) == 0
    assert cli.main(["prepare-data", "--config", str(ws / "config.json"),
                     "--renders", str(ws / "renders"), "--out", str(ws / "shards")]) == 0
    assert cli.main(["train", "--config", str(ws / "config.json"), "--workdir", str(ws / "run"),
                     "--shards", str(ws / "shards"), "--steps", "2", "--device", "cpu"]) == 0
    return ws


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_prepare_data_writes_shards_the_jax_reader_reads(workspace):
    meta = jshards.ShardMeta.from_json((workspace / "shards" / "train" / "meta.json").read_text())
    reader = jshards.ShardReader(workspace / "shards" / "train")
    assert len(reader) == meta.n_examples == 16
    assert reader[0]["source/combined"].shape == (32, 32, 3)


@pytest.mark.parametrize("command", ["synth-data", "prepare-data"])
def test_host_commands_take_no_device(command, tmp_path, capsys):
    """synth-data and prepare-data run on the host: --device is refused,
    not ignored."""
    argv = {"synth-data": ["synth-data", "--out", str(tmp_path)],
            "prepare-data": ["prepare-data", "--renders", str(tmp_path), "--out", str(tmp_path)]}
    with pytest.raises(SystemExit) as e:
        cli.main(argv[command] + ["--device", "cpu"])
    assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_train_writes_checkpoint_metrics_and_config(workspace):
    run = workspace / "run"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["2"]
    lines = _lines(run / "metrics_train.jsonl")
    assert [m["step"] for m in lines] == [2]
    assert np.isfinite(lines[-1]["loss"]) and np.isfinite(lines[-1]["grad_norm"])
    evals = _lines(run / "metrics_eval.jsonl")
    assert [m["step"] for m in evals] == [2]
    assert {"loss", "psnr_tm", "ssim_tm", "ema_psnr_tm", "noisy_psnr_tm"} <= set(evals[0])
    assert (run / "previews" / "step_00000002.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert config.load(run / "config.json").model.in_channels == 14  # group mode, validated


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "raw"])
def test_denoise_from_the_checkpoint(workspace, ema, tmp_path):
    frame_dir = workspace / "renders" / "frame0000" / "spp4_seed0"
    out = tmp_path / "out.exr"
    argv = ["denoise", "--config", str(workspace / "config.json"),
            "--checkpoint", str(workspace / "run" / "checkpoints"),
            "--frame", str(frame_dir), "--out", str(out), "--device", "cpu"]
    assert cli.main(argv + (["--ema"] if ema else [])) == 0
    img = exr.read_exr(out)
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()


def test_eval_from_the_checkpoint(workspace, capsys):
    rc = cli.main(["eval", "--config", str(workspace / "config.json"),
                   "--checkpoint", str(workspace / "run" / "checkpoints"),
                   "--renders", str(workspace / "renders"), "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["n_frames"] == 3 and np.isfinite(report["psnr_mean"])


def test_train_resumes_and_its_metrics_continue(workspace):
    """Runs after the tests that read the step-2 checkpoint (file order)."""
    run = workspace / "run"
    assert cli.main(["train", "--config", str(workspace / "config.json"), "--workdir", str(run),
                     "--shards", str(workspace / "shards"), "--device", "cpu"]) == 0
    assert [m["step"] for m in _lines(run / "metrics_train.jsonl")] == [2, 4, 6]
    assert sorted(int(p.name) for p in (run / "checkpoints").iterdir()) == [2, 3, 6]


# the fault's config, cut to the workspace's 48x48 frames
FLAGS_OUTSIDE_JOINT = {"data": {"mode": "group", "use_flags": True, "crop": 32,
                                "crops_per_frame": 4, "validation_fraction": 0.34}}


@pytest.fixture(scope="module")
def flags_config(workspace):
    """A config whose mode/flags pair fails the channel check: prepare-data
    reads only its data section, denoise and eval must refuse it."""
    path = workspace / "flags_group.json"
    path.write_text(json.dumps(FLAGS_OUTSIDE_JOINT))
    return path


def test_prepare_data_accepts_what_the_jax_command_accepts(workspace, flags_config, tmp_path):
    from deepdenoiser_tpu import cli as jcli

    renders = str(workspace / "renders")
    assert jcli.main(["prepare-data", "--config", str(flags_config), "--renders", renders,
                      "--out", str(tmp_path / "jax")]) == 0
    assert cli.main(["prepare-data", "--config", str(flags_config), "--renders", renders,
                     "--out", str(tmp_path / "port")]) == 0
    splits = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "train" in splits
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == splits
    for split in splits:
        jdir, pdir = tmp_path / "jax" / split, tmp_path / "port" / split
        assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
        jmeta = json.loads((jdir / "meta.json").read_text())
        assert json.loads((pdir / "meta.json").read_text()) == jmeta
        assert jmeta["flags_dim"] == 4
        jreader, preader = jshards.ShardReader(jdir), jshards.ShardReader(pdir)
        assert len(preader) == len(jreader) > 0
        for i in range(len(jreader)):
            want, got = jreader[i], preader[i]
            assert sorted(got) == sorted(want)
            for key, arr in want.items():
                np.testing.assert_array_equal(got[key], arr)


@pytest.mark.parametrize("command", ["denoise", "eval"])
def test_denoise_and_eval_still_refuse_a_config_that_fails_the_channel_check(
        command, workspace, flags_config, tmp_path):
    from deepdenoiser_tpu import cli as jcli

    tail = {"denoise": ["--frame", str(workspace / "renders" / "frame0000" / "spp4_seed0"),
                        "--out", str(tmp_path / "out.exr")],
            "eval": ["--renders", str(workspace / "renders")]}[command]
    argv = [command, "--config", str(flags_config), "--weights", str(tmp_path / "none.npz"),
            *tail]
    with pytest.raises(ValueError, match="use_flags requires mode='joint'"):
        jcli.main(argv)
    with pytest.raises(ValueError, match="use_flags requires mode='joint'"):
        cli.main(argv + ["--device", "cpu"])
