"""The port's data-parallel training (parallel/dist.py, training/train.py,
data/loader.py, training/checkpoint.py, training/loop.py) on CPU ranks
over gloo, against the JAX package's shard_map + pmean step on an N-device
CPU mesh and against the port's own one-rank step on the global batch.

Ranks are spawned processes (tests/torch_dp_worker.py, which imports no
JAX) that meet through a file:// rendezvous under tmp_path. Each spawn
costs a few seconds, so every rank count is spawned once per module and
its results are read by several tests.

Tolerances: against JAX, the port's train-step bars
(tests/test_torch_train.py): loss, psnr_encoded and grad_norm within rel
1e-4, parameters and EMA within 1e-3 * lr. Adam's quotient m/sqrt(v) is
ill-conditioned where a gradient element changes sign between steps: on
this batch one weight of the first conv (|g| ~ 2e-5 of the global norm)
already parts by 3e-3 lr between the two packages on ONE device, and the
ranks' summation order moves such elements by up to 2e-6 in either
package (its rank invariant). At most 1 in 1000 elements may exceed 1e-3
* lr, and each of them stays within its one-device gap plus the two rank
invariants (4e-6). Against
the one-rank global step (the invariant of tests/test_train.py:31-50):
loss and grad_norm within rel 1e-5, parameters within 2e-6: the ranks'
gradients and losses are the global ones summed in another order.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu.data import loader as jloader
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.parallel import mesh as jmesh
from deepdenoiser_tpu.training import train as jtrain
from deepdenoiser_tpu_torch import cli, config, weights_io
from deepdenoiser_tpu_torch.data import exr, loader, prepare, synthetic
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.ops import metrics
from deepdenoiser_tpu_torch.ops.losses import LossConfig
from deepdenoiser_tpu_torch.training import loop, train
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

import torch_dp_worker  # noqa: E402  (tests/, on the path of every test module)

LR = 2e-4
STEPS = 3
TINY_KPN = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=1,
                convs_per_level=1, kernel_prediction=True, kpn_size=5, kpn_slots=8,
                kpn_logit_norm=True, act="leaky_relu")
TKW = dict(learning_rate=LR, warmup_steps=0, ema_decay=0.9, steps=200)
BATCH = 8  # divides into 2 and 4 ranks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _raw_joint_batch(n=BATCH, s=16):
    """n different raw crops, as the loader hands them over."""
    from deepdenoiser_tpu_torch.data import shards

    raw = {}
    for i in range(n):
        clean = synthetic.generate_clean_passes(s, s, seed=20 + i)
        noisy = synthetic.add_mc_noise(clean, spp=4, seed=40 + i)
        for role, d, names in (("source", noisy, prepare.default_source_passes()),
                               ("target", clean, prepare.default_target_passes())):
            for p in names:
                raw.setdefault(f"{role}/{p}", []).append(d[p].astype(shards._disk_dtype(p)))
    return {k: np.stack(v) for k, v in raw.items()}


@pytest.fixture(scope="module")
def start():
    """The JAX initialisation, a global train batch (encoded from raw
    crops) and a raw eval batch."""
    jm = jfactory.ModelConfig(**TINY_KPN)
    jparams = jfactory.init_params(jm, jax.random.PRNGKey(0), spatial=16)
    raw = _raw_joint_batch()
    enc = loader.make_batch_encoder(config.DataConfig(mode="joint"))(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    rng = np.random.default_rng(1)
    batch = {"x": enc["x"].numpy(),
             "y": (enc["y"].numpy() + 0.05 * rng.standard_normal(enc["y"].shape)).astype(np.float32)}
    return jparams, batch, raw


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def ranks(request, start, tmp_path_factory):
    n = request.param
    jparams, batch, raw = start
    res = torch_dp_worker.spawn(
        torch_dp_worker.train_steps, n, tmp_path_factory.mktemp(f"dp{n}"), "cpu",
        TINY_KPN, TKW, weights_io.flatten(_np(jparams)), batch, STEPS, raw,
        config.DataConfig(mode="joint"))
    return n, res


def _jax_steps(n, jparams, batch):
    jm, jt = jfactory.ModelConfig(**TINY_KPN), jconfig.TrainConfig(**TKW)
    mesh = jmesh.make_mesh(n)
    step = jtrain.make_train_step(jm, jt, mesh)
    opt = jtrain.make_optimizer(jt)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),  # copies: the step donates
                              params=jax.tree.map(jnp.copy, jparams),
                              opt_state=opt.init(jparams),
                              ema_params=jax.tree.map(jnp.copy, jparams))
    mets = []
    for _ in range(STEPS):
        state, m = step(state, jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        mets.append({k: float(v) for k, v in m.items()})
    return state, mets, mesh


@pytest.fixture(scope="module")
def one_device(start):
    """Both packages' steps on one device and the global batch: the port's
    metrics and state, and JAX's state."""
    jparams, batch, _ = start
    jm, jt = jfactory.ModelConfig(**TINY_KPN), jconfig.TrainConfig(**TKW)
    opt = jtrain.make_optimizer(jt)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=jax.tree.map(jnp.copy, jparams),
                               opt_state=opt.init(jparams),
                               ema_params=jax.tree.map(jnp.copy, jparams))
    jstep = jtrain.make_train_step(jm, jt)
    m, t = factory.ModelConfig(**TINY_KPN), config.TrainConfig(**TKW)
    state = train.create_state(m, t, device="cpu", params=_np(jparams))
    step = train.make_train_step(m, t)
    mets = []
    for _ in range(STEPS):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, out = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        mets.append({k: float(v) for k, v in out.items()})
    jflat = {f"{prefix}/{k}": v for prefix, tree in (("params", jstate.params),
                                                     ("ema", jstate.ema_params))
             for k, v in weights_io.flatten(_np(tree)).items()}
    return mets, torch_dp_worker.flat_state(state), jflat


def test_dp_step_matches_jax_on_an_n_device_mesh(devices8, start, ranks, one_device):
    n, res = ranks
    jparams, batch, raw = start
    _, port1, jax1 = one_device
    jstate, jmets, mesh = _jax_steps(n, jparams, batch)
    for got, want in zip(res[0]["mets"], jmets):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    state = res[0]["state"]
    bar, over, total = 1e-3 * LR, 0, 0
    for prefix, tree in (("params", jstate.params), ("ema", jstate.ema_params)):
        for k, v in weights_io.flatten(_np(tree)).items():
            key = f"{prefix}/{k}"
            gap = np.abs(state[key] - v)
            # where Adam's quotient is ill-conditioned: the one-device gap
            # plus both packages' rank invariants (2e-6 each)
            limit = np.abs(port1[key] - jax1[key]) + 4e-6
            over += int((gap > bar).sum())
            total += v.size
            assert (gap <= np.maximum(bar, limit)).all(), (key, gap.max() / LR)
    assert over <= total // 1000, (over, total)
    # the full eval step: each rank's share, the mean of the ranks' metrics
    jm = jfactory.ModelConfig(**TINY_KPN)
    want = jtrain.make_full_eval_step(jm, jconfig.DataConfig(mode="joint"),
                                      jconfig.TrainConfig(**TKW).loss, mesh)(
        jstate, jmesh.shard_batch({k: jnp.asarray(v) for k, v in raw.items()}, mesh))
    got = res[0]["eval"]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4), k


def test_dp_step_matches_the_one_rank_step_on_the_global_batch(start, ranks, one_device):
    n, res = ranks
    jparams, batch, _ = start
    one_mets, want, _ = one_device
    # psnr_encoded is the mean of the ranks' PSNRs (pmean of per-shard
    # PSNRs): the first step's, from the starting parameters
    model = train.create_state(factory.ModelConfig(**TINY_KPN), config.TrainConfig(**TKW),
                               device="cpu", params=_np(jparams)).model
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["x"]))
        y = torch.from_numpy(batch["y"])
        per_rank = [float(metrics.psnr(p, t_, data_range=4.0))
                    for p, t_ in zip(pred.chunk(n), y.chunk(n))]
    assert res[0]["mets"][0]["psnr_encoded"] == pytest.approx(np.mean(per_rank), rel=1e-5)
    for got, ref in zip(res[0]["mets"], one_mets):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    for k, v in res[0]["state"].items():
        if k.startswith(("params/", "ema/")):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=2e-6, err_msg=k)


def test_dp_ranks_keep_the_same_state(ranks):
    """The same averaged gradients on every rank: parameters, EMA and
    Adam's moments stay bit-equal, and so do the metrics; the model is not
    wrapped, so its state_dict keys are the one-rank keys."""
    n, res = ranks
    assert len(res) == n
    for r in res[1:]:
        assert r["mets"] == res[0]["mets"] and r["eval"] == res[0]["eval"]
        assert r["state"].keys() == res[0]["state"].keys()
        for k, v in res[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    one = train.create_state(factory.ModelConfig(**TINY_KPN), config.TrainConfig(**TKW),
                             device="cpu")
    assert {k for k in res[0]["state"] if k.startswith("params/")} == {
        k for k in torch_dp_worker.flat_state(one) if k.startswith("params/")}
    # CPU tensors: the filter apply and its backward run their plain versions
    assert all(launches == (0, 0) for r in res for launches in r["launches"])


# ---------------------------------------------------------------------------
# the loader's two splits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp-fit")
    cfg = _experiment(steps=5)
    prepare.generate_synthetic_render_root(root / "renders", n_frames=3, height=40, width=40,
                                           spps=(4,), seed=3)
    prepare.prepare_dataset(root / "renders", root / "shards", cfg.data)
    return root / "shards"


def test_loader_host_sharding_matches_jax(shards):
    """tests/test_pipeline_data.py:61-69: two hosts see disjoint examples
    that together cover the split, and the same batches as JAX's."""
    dcfg = _experiment(steps=5).data
    jcfg = jconfig.DataConfig(**dataclasses.asdict(dcfg))
    n = 0
    seen = []
    for host in range(2):
        src = loader.make_dataset(shards / "train", dcfg, training=False, host_count=2,
                                  host_index=host, drop_remainder=False)
        jds = jloader.make_dataset(str(shards / "train"), jcfg, training=False, host_count=2,
                                   host_index=host, drop_remainder=False)
        got = list(loader.iterate_epoch(src))
        want = list(jds)
        assert len(got) == len(want) == src.batches_per_epoch
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
        n += sum(b["source/combined"].shape[0] for b in got)
        seen.append(set(src.order(0).tolist()))
    assert n == src._reader.meta.n_examples
    assert not seen[0] & seen[1]


@pytest.mark.parametrize("world", [2, 4])
def test_loader_share_gives_each_rank_its_rows_of_the_global_batch(shards, world):
    dcfg = _experiment(steps=5).data
    dcfg = dataclasses.replace(dcfg, batch_size=4)
    one = loader.make_dataset(shards / "train", dcfg)
    parts = [loader.make_dataset(shards / "train", dcfg, share=(r, world)) for r in range(world)]
    for e, b in ((0, 0), (0, one.batches_per_epoch - 1), (1, 0)):
        want = one[(e, b)]
        got = [p[(e, b)] for p in parts]
        for k in want:
            torch.testing.assert_close(torch.cat([g[k] for g in got]), want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="divide"):
        loader.make_dataset(shards / "train", dataclasses.replace(dcfg, batch_size=6),
                            share=(0, 4))


# ---------------------------------------------------------------------------
# fit on two ranks
# ---------------------------------------------------------------------------


def _experiment(steps, eval_every=1000):
    return config.ExperimentConfig(
        name="dp-fit-test",
        model=factory.ModelConfig(backbone="unet", base_width=4, depth=1, convs_per_level=1),
        data=config.DataConfig(crop=16, crops_per_frame=4, batch_size=4,
                               validation_fraction=0.34, seed=1, read_threads=1),
        train=config.TrainConfig(steps=steps, warmup_steps=2, learning_rate=1e-3,
                                 log_every=1, eval_every=eval_every, checkpoint_every=1000,
                                 ema_decay=0.9, loss=LossConfig(gradient_weight=0.5)),
    )


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_fit_on_two_ranks_equals_fit_on_one(shards, tmp_path):
    """fit for 3 steps on 2 ranks writes one checkpoint, resumes to 5 and
    equals fit on one process; rank 0 alone writes the files; a SIGTERM
    to rank 1 alone stops both at the same step; one process's `denoise
    --checkpoint` loads what 2 ranks wrote."""
    cfg = _experiment(steps=5, eval_every=5)
    res = torch_dp_worker.spawn(
        torch_dp_worker.fit_ranks, 2, tmp_path, "cpu", cfg, shards, tmp_path / "two", 3,
        _experiment(steps=6), tmp_path / "sigterm")
    one = loop.fit(cfg, tmp_path / "one", shard_dir=str(shards), device="cpu")
    assert [r["first_step"] for r in res] == [3, 3] and [r["resumed_step"] for r in res] == [5, 5]
    assert res[0]["first_checkpoints"] == [3]
    want = torch_dp_worker.flat_state(one)
    for r in res:
        for k, v in r["resumed"].items():
            if k.startswith(("params/", "ema/")):
                np.testing.assert_allclose(v, want[k], rtol=0, atol=2e-6, err_msg=k)
    for k, v in res[0]["resumed"].items():
        np.testing.assert_array_equal(res[1]["resumed"][k], v, err_msg=k)
    # one metrics file, one record a step, the one-rank losses
    got, ref = _records(tmp_path / "two" / "metrics_train.jsonl"), _records(
        tmp_path / "one" / "metrics_train.jsonl")
    assert [g["step"] for g in got] == [1, 2, 3, 4, 5]
    for g, w in zip(got, ref):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
    # the eval at step 5 splits the validation batches over the ranks
    (ge,), (we,) = _records(tmp_path / "two" / "metrics_eval.jsonl"), _records(
        tmp_path / "one" / "metrics_eval.jsonl")
    assert ge.keys() == we.keys() and ge["loss"] == pytest.approx(we["loss"], rel=1e-5)
    assert CheckpointManager(tmp_path / "two" / "checkpoints").steps() == [3, 5]
    assert config.load(tmp_path / "two" / "config.json") == config.validate_channels(cfg)
    # SIGTERM on rank 1: both ranks stop and save at step 2
    assert [r["sigterm_step"] for r in res] == [2, 2]
    assert CheckpointManager(tmp_path / "sigterm" / "checkpoints").steps() == [2]
    # the 2-rank checkpoint in one process
    clean = synthetic.generate_clean_passes(32, 48, seed=0)
    exr.save_frame_dir(tmp_path / "frame", synthetic.add_mc_noise(clean, spp=4, seed=1))
    assert cli.main(["denoise", "--config", str(tmp_path / "two" / "config.json"),
                     "--checkpoint", str(tmp_path / "two" / "checkpoints"), "--ema",
                     "--frame", str(tmp_path / "frame"), "--out", str(tmp_path / "out.exr"),
                     "--device", "cpu"]) == 0
    out = exr.read_exr(tmp_path / "out.exr")
    assert out.shape[:2] == (32, 48) and np.isfinite(out).all()
    restored = train.create_state(config.validate_channels(cfg).model, cfg.train, device="cpu")
    CheckpointManager(tmp_path / "two" / "checkpoints").restore_latest(restored)
    for k, v in torch_dp_worker.flat_state(restored).items():
        np.testing.assert_array_equal(v, res[0]["resumed"][k], err_msg=k)


def test_fit_refuses_a_batch_that_does_not_divide_over_the_ranks(shards, tmp_path):
    from deepdenoiser_tpu_torch.parallel import dist

    cfg = _experiment(steps=1)
    group = dist.DataGroup(rank=0, world=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        loop.fit(cfg, tmp_path, shard_dir=str(shards), group=group)
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_parallel=False))
    with pytest.raises(ValueError, match="data_parallel is off"):
        loop.fit(off, tmp_path, shard_dir=str(shards), group=group)


@pytest.mark.parametrize("cards,local_world,local_rank,want", [
    (1, 2, 1, ("cuda:0", "gloo")), (2, 2, 1, ("cuda:1", "nccl")), (2, 4, 3, ("cuda:1", "gloo")),
    (4, 4, 2, ("cuda:2", "nccl")),
])
def test_a_rank_takes_its_card_and_the_backend_follows_the_sharing(monkeypatch, cards,
                                                                   local_world, local_rank, want):
    """cuda:(LOCAL_RANK % device_count); nccl only when every rank on the
    host has a card of its own; CPU ranks always gloo."""
    from deepdenoiser_tpu_torch.parallel import dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    dev, backend, _ = dist.choose(local_rank, local_world)
    assert (str(dev), backend) == want
    dev, backend, _ = dist.choose(local_rank, local_world, "cpu")
    assert (str(dev), backend) == ("cpu", "gloo")
