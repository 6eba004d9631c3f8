"""The port's checkpoints and fit loop on the CPU (training/checkpoint.py,
training/loop.py): a checkpoint round trip restores the whole train state,
the newest `keep` are kept, a save killed half way leaves nothing that
loads, `fit` for 6 steps equals `fit` for 3 and a resumed `fit` for 3 more
bit for bit, and SIGTERM saves and stops.

The port's checkpoints are torch.save files, not orbax's: the JAX
package's checkpoint tests (tests/test_train.py) are the behaviour held
to, not the bytes.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config
from deepdenoiser_tpu_torch.data import prepare
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops.losses import LossConfig
from deepdenoiser_tpu_torch.training import loop, train
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

TINY = ModelConfig(backbone="unet", in_channels=8, out_channels=6, base_width=8, depth=1,
                   convs_per_level=1)  # the tiny model of tests/test_train.py


def _state(seed=0, ema=0.9):
    tcfg = config.TrainConfig(steps=20, warmup_steps=2, ema_decay=ema)
    return tcfg, train.create_state(TINY, tcfg, seed=seed, device="cpu")


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal((4, 16, 16, 8)).astype(np.float32)),
            "y": torch.from_numpy(0.1 * rng.standard_normal((4, 16, 16, 6)).astype(np.float32))}


def _tensors(state):
    sd = state.state_dict()
    out = {f"params.{k}": v for k, v in sd["params"].items()}
    out.update({f"ema.{k}": v for k, v in (sd["ema_params"] or {}).items()})
    for i, st in sd["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


def _assert_same_state(a, b):
    assert a.step == b.step
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.scheduler.state_dict() == b.scheduler.state_dict()


def test_checkpoint_round_trip_restores_the_whole_state(tmp_path):
    tcfg, state = _state()
    step = train.make_train_step(TINY, tcfg)
    for _ in range(3):
        state, _ = step(state, _batch())
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    assert mgr.restore_latest(_state(seed=5)[1]) is None
    extra = {"data_iter": {"epoch": 1, "position": 2}, "config": {"name": "x"}}
    assert mgr.save(state.step, state, extra=extra)
    assert not mgr.save(state.step, state)  # that step exists: nothing written
    restored, got_extra = mgr.restore_latest(_state(seed=5)[1])
    mgr.close()
    assert got_extra == extra
    _assert_same_state(restored, state)
    # the next update from the restored state is the uninterrupted one's
    restored, m1 = step(restored, _batch(2))
    state, m2 = step(state, _batch(2))
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same_state(restored, state)


def test_restore_refuses_a_state_that_disagrees_on_the_ema(tmp_path):
    _, state = _state(ema=0.9)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(0, state)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore_latest(_state(ema=0.0)[1])


def test_checkpoint_keep_limit(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    for s in range(1, 5):
        state.step = s
        mgr.save(s, state)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(p.name for p in mgr.directory.iterdir()) == ["3", "4"]


def test_a_save_killed_half_way_is_ignored(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(tmp_path / "ckpt", keep=3)
    state.step = 2
    mgr.save(2, state)
    # what a save killed before its rename leaves: a temporary directory
    # with a partial file, and a step directory with no state file
    tmp = mgr.directory / ".tmp-7-12345"
    tmp.mkdir()
    (tmp / "state.pt").write_bytes(b"\x80\x02partial")
    (mgr.directory / "9").mkdir()
    assert mgr.latest_step() == 2
    restored, _ = mgr.restore_latest(_state(seed=3)[1])
    assert restored.step == 2
    state.step = 3
    mgr.save(3, state)
    assert not tmp.exists()  # the next save clears the leftovers
    assert mgr.steps() == [2, 3]


# ---------------------------------------------------------------------------
# fit: resume and SIGTERM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    cfg = _experiment(steps=6)
    prepare.generate_synthetic_render_root(root / "renders", n_frames=3, height=40, width=40,
                                           spps=(4,), seed=3)
    prepare.prepare_dataset(root / "renders", root / "shards", cfg.data)
    return root / "shards"


def _experiment(steps):
    return config.ExperimentConfig(
        name="fit-test",
        model=ModelConfig(backbone="unet", base_width=4, depth=1, convs_per_level=1),
        data=config.DataConfig(crop=16, crops_per_frame=4, batch_size=4,
                               validation_fraction=0.34, seed=1, read_threads=1),
        train=config.TrainConfig(steps=steps, warmup_steps=2, learning_rate=1e-3,
                                 log_every=1, eval_every=1000, checkpoint_every=1000,
                                 ema_decay=0.9, loss=LossConfig(gradient_weight=0.5)),
    )


def _metrics(workdir):
    lines = (workdir / "metrics_train.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in lines]


def test_fit_resumed_equals_fit_uninterrupted_bitwise(shards, tmp_path):
    cfg = _experiment(steps=6)
    whole = loop.fit(cfg, tmp_path / "whole", shard_dir=str(shards), device="cpu")
    first = loop.fit(cfg, tmp_path / "split", shard_dir=str(shards), max_steps=3, device="cpu")
    assert first.step == 3
    assert CheckpointManager(tmp_path / "split" / "checkpoints").steps() == [3]
    extra = json.loads((tmp_path / "split" / "checkpoints" / "3" / "extra.json").read_text())
    per_epoch = loop.loader_lib.make_dataset(shards / "train", cfg.data).batches_per_epoch
    assert extra["data_iter"] == {"epoch": 3 // per_epoch, "position": 3 % per_epoch}
    assert extra["config"] == json.loads((tmp_path / "split" / "config.json").read_text())
    resumed = loop.fit(cfg, tmp_path / "split", shard_dir=str(shards), device="cpu")
    assert whole.step == resumed.step == 6
    _assert_same_state(resumed, whole)
    got, want = _metrics(tmp_path / "split"), _metrics(tmp_path / "whole")
    assert [m["step"] for m in got] == list(range(1, 7))
    assert got == want  # the metrics file continues with the same numbers
    assert config.load(tmp_path / "split" / "config.json") == config.validate_channels(cfg)


def test_sigterm_saves_and_stops(shards, tmp_path, monkeypatch, capsys):
    make = train.make_train_step

    def make_with_sigterm(mcfg, tcfg, mesh=None):
        step = make(mcfg, tcfg, mesh)

        def stepped(state, batch):
            state, mets = step(state, batch)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, mets

        return stepped

    monkeypatch.setattr(train, "make_train_step", make_with_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    state = loop.fit(_experiment(steps=6), tmp_path, shard_dir=str(shards), device="cpu")
    assert state.step == 2
    assert CheckpointManager(tmp_path / "checkpoints").steps() == [2]
    assert "SIGTERM: saved at step 2" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) == before


def test_fit_without_a_card_raises(shards, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: fit runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.fit(_experiment(steps=1), tmp_path, shard_dir=str(shards))
