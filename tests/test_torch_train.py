"""The port's training step against the JAX package's
(deepdenoiser_tpu/training/train.py): TrainConfig JSON both ways, the
learning-rate schedule and one optimizer update against optax, three train
steps from JAX-initialised parameters carried across by weights_io, the
EMA, Flax-style initialisation, remat, the full eval step and NaN inputs.

Tolerances: loss, grad_norm and psnr_encoded within rel 1e-4 (fp32 sums in
another order; measured <= 6e-6). Parameters: Adam's first steps move every
parameter by about the learning rate whatever its gradient's size (the
update is lr * m_hat / (sqrt(v_hat) + eps)), so the two packages'
parameters differ by the rounding of that quotient, except where a
gradient element is so close to 0 that eps decides it; the bar is
max|Δp| <= 1e-3 * lr after three steps (measured <= 4e-4 * lr).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu.data import loader as jloader
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.training import train as jtrain
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.data import loader
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.training import train

REL = 1e-4
LR = 2e-4  # the TrainConfig default; at 10x it a tiny KPN's step-3 grad_norm already
# moves 5e-4 apart: logit_norm makes its loss so curved that parameters 1e-4 lr apart
# after one step give gradients 1e-4 apart


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_params(state):
    return weights_io.flatten(weights_io.params_from_state_dict(state.model.state_dict()))


def _flat_ema(state):
    return weights_io.flatten(weights_io.params_from_state_dict(state.ema_params))


TINY_UNET = dict(backbone="unet", in_channels=8, out_channels=6, base_width=8, depth=1,
                 convs_per_level=1)  # the tiny model of tests/test_train.py
TINY_KPN = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=1,
                convs_per_level=1, kernel_prediction=True, kpn_size=5, kpn_slots=8,
                kpn_logit_norm=True, act="leaky_relu")
TINY_MULTISCALE = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=1,
                       convs_per_level=1, n_scales=2, predict_residual=True, act="leaky_relu")


def _batch(mkw, seed=1, n=4, s=16, teacher=False):
    rng = np.random.default_rng(seed)
    x = rng.random((n, s, s, mkw["in_channels"])).astype(np.float32)
    if mkw["out_channels"] == 24:
        sig = np.concatenate([x[..., 9 * g : 9 * g + 6] for g in range(4)], axis=-1)
    else:
        sig = x[..., : mkw["out_channels"]]
    batch = {"x": x, "y": (sig + 0.1 * rng.standard_normal(sig.shape)).astype(np.float32)}
    if teacher:
        batch["y_teacher"] = (sig + 0.05 * rng.standard_normal(sig.shape)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_train_config_keeps_the_reference_fields_and_defaults():
    assert config.to_dict(config.TrainConfig()) == jconfig.to_dict(jconfig.TrainConfig())


def test_train_config_json_both_ways(tmp_path):
    from deepdenoiser_tpu.ops.losses import LossConfig as JLossConfig
    from deepdenoiser_tpu_torch.ops.losses import LossConfig

    kw = dict(steps=123, learning_rate=3e-4, warmup_steps=7, schedule="constant",
              weight_decay=1e-4, grad_clip_norm=0.5, ema_decay=0.99, checkpoint_every=11,
              scale_supervision_weight=0.25, distill_weight=0.3)
    loss_kw = dict(kind="l1", gradient_weight=0.0, ms_ssim_weight=0.2)
    ours = dataclasses.replace(config.PRESETS["kpn-hq"],
                               train=config.TrainConfig(**kw, loss=LossConfig(**loss_kw)))
    ref = dataclasses.replace(jconfig.PRESETS["kpn-hq"],
                              train=jconfig.TrainConfig(**kw, loss=JLossConfig(**loss_kw)))
    config.save(ours, tmp_path / "port.json")
    jconfig.save(ref, tmp_path / "jax.json")
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert jconfig.load(tmp_path / "port.json") == ref
    assert config.load(tmp_path / "jax.json") == ours


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,warmup,steps", [
    ("cosine", 10, 50), ("cosine", 0, 30), ("cosine", 20, 15), ("constant", 10, 40),
    ("constant", 0, 10)])
def test_schedule_matches_optax_at_every_step(schedule, warmup, steps):
    tcfg = config.TrainConfig(schedule=schedule, warmup_steps=warmup, steps=steps,
                              learning_rate=2.5e-4)
    jcfg = jconfig.TrainConfig(schedule=schedule, warmup_steps=warmup, steps=steps,
                               learning_rate=2.5e-4)
    model = torch.nn.Linear(2, 2)
    opt, sched = train.make_optimizer(tcfg, model.parameters())
    for step in range(steps + 15):
        want = float(_optax_lr(jcfg, step))
        # optax evaluates in fp32: equal up to its rounding of the peak rate
        assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-6, abs=1e-6 * 2.5e-4), step
        opt.step()
        sched.step()


def _optax_lr(jcfg, step):
    """The schedule the JAX package's make_optimizer builds
    (training/train.py:42-58), evaluated by optax."""
    if jcfg.schedule == "cosine":
        sched = optax.warmup_cosine_decay_schedule(
            0.0, jcfg.learning_rate, jcfg.warmup_steps, max(jcfg.steps, jcfg.warmup_steps + 1))
    else:
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, jcfg.learning_rate, jcfg.warmup_steps),
             optax.constant_schedule(jcfg.learning_rate)], [jcfg.warmup_steps])
    return sched(step)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        train.make_optimizer(config.TrainConfig(schedule="linear"), torch.nn.Linear(1, 1).parameters())


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "unclipped"])
def test_one_update_matches_optax(weight_decay, grad_scale):
    """clip_by_global_norm + adam(w) on the same parameters and gradients;
    grad_norm is the norm before clipping."""
    mkw = TINY_UNET
    tkw = dict(learning_rate=LR, warmup_steps=0, schedule="constant", weight_decay=weight_decay,
               ema_decay=0.9)
    jparams = jfactory.init_params(jfactory.ModelConfig(**mkw), jax.random.PRNGKey(3), spatial=16)
    state = train.create_state(factory.ModelConfig(**mkw), config.TrainConfig(**tkw),
                               device="cpu", params=_np(jparams))
    rng = np.random.default_rng(4)
    jgrads = jax.tree.map(
        lambda p: jnp.asarray((grad_scale * rng.standard_normal(p.shape)).astype(np.float32)),
        jparams)
    gsd = weights_io.state_dict_from_params(_np(jgrads))
    for name, p in state.model.named_parameters():
        p.grad = gsd[name].clone()
    mets = train._apply_update(config.TrainConfig(**tkw), state, {})

    jt = jconfig.TrainConfig(**tkw)
    tx = jtrain.make_optimizer(jt)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    want = weights_io.flatten(_np(optax.apply_updates(jparams, updates)))
    got = _flat_params(state)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-3 * LR, err_msg=k)
    assert float(mets["grad_norm"]) == pytest.approx(float(optax.global_norm(jgrads)), rel=1e-6)
    assert state.step == 1
    # EMA after the update: e*d + p*(1-d), from e = the initial parameters
    init = weights_io.flatten(_np(jparams))
    for k, e in _flat_ema(state).items():
        np.testing.assert_allclose(e, init[k] * 0.9 + got[k] * 0.1, rtol=1e-6, atol=1e-9)


def test_clipping_has_no_epsilon():
    """Exactly at the limit nothing changes; above it the norm becomes the
    limit exactly (clip_grad_norm_ would add 1e-6 to the norm)."""
    model = torch.nn.Linear(3, 1, bias=False)
    tcfg = config.TrainConfig(grad_clip_norm=1.0, learning_rate=0.0, warmup_steps=0,
                              schedule="constant")
    opt, sched = train.make_optimizer(tcfg, model.parameters())
    state = train.TrainState(0, model, opt, sched, None)
    model.weight.grad = torch.tensor([[3.0, 4.0, 0.0]])
    mets = train._apply_update(tcfg, state, {})
    assert float(mets["grad_norm"]) == 5.0
    assert torch.equal(model.weight.grad, torch.tensor([[0.6, 0.8, 0.0]]))


# ---------------------------------------------------------------------------
# train steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["unet", "joint-kpn", "multiscale", "distill"])
def test_three_train_steps_match_jax(case):
    mkw = {"unet": TINY_UNET, "joint-kpn": TINY_KPN, "multiscale": TINY_MULTISCALE,
           "distill": TINY_UNET}[case]
    tkw = dict(steps=100, learning_rate=LR, warmup_steps=2, ema_decay=0.9)
    if case == "multiscale":
        tkw["scale_supervision_weight"] = 0.5
    if case == "distill":
        tkw["distill_weight"] = 0.3
    jm, jt = jfactory.ModelConfig(**mkw), jconfig.TrainConfig(**tkw)
    m, t = factory.ModelConfig(**mkw), config.TrainConfig(**tkw)
    jstate = jtrain.create_state(jm, jt, jax.random.PRNGKey(0), spatial=16)
    state = train.create_state(m, t, device="cpu", params=_np(jstate.params))
    jstep, step = jtrain.make_train_step(jm, jt), train.make_train_step(m, t)
    batch = _batch(mkw, teacher=case == "distill")
    for i in range(3):
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, mets = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(mets) == set(jmets) == {"loss", "psnr_encoded", "grad_norm"}
        for k in jmets:
            assert float(mets[k]) == pytest.approx(float(jmets[k]), rel=REL), (i, k)
    assert state.step == int(jstate.step) == 3
    want, got = weights_io.flatten(_np(jstate.params)), _flat_params(state)
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-3 * LR, err_msg=k)
    jema, ema = weights_io.flatten(_np(jstate.ema_params)), _flat_ema(state)
    for k, v in jema.items():
        np.testing.assert_allclose(ema[k], v, rtol=0, atol=1e-3 * LR, err_msg=k)


def test_train_step_is_deterministic_on_the_cpu():
    m, t = factory.ModelConfig(**TINY_KPN), config.TrainConfig(warmup_steps=0, learning_rate=LR)
    batch = {k: torch.from_numpy(v) for k, v in _batch(TINY_KPN).items()}
    outs = []
    for _ in range(2):
        state = train.create_state(m, t, seed=5, device="cpu")
        state, mets = train.make_train_step(m, t)(state, batch)
        outs.append((float(mets["loss"]), _flat_params(state)))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        np.testing.assert_array_equal(v, outs[1][1][k])


def test_nan_inputs_surface_in_the_metrics():
    m, t = factory.ModelConfig(**TINY_UNET), config.TrainConfig(warmup_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(TINY_UNET).items()}
    batch["x"][0, 3, 3, 0] = float("nan")
    state = train.create_state(m, t, device="cpu")
    state, mets = train.make_train_step(m, t)(state, batch)
    assert math.isnan(float(mets["loss"])) and math.isnan(float(mets["grad_norm"]))
    jm, jt = jfactory.ModelConfig(**TINY_UNET), jconfig.TrainConfig(warmup_steps=0)
    jstate = jtrain.create_state(jm, jt, jax.random.PRNGKey(0), spatial=16)
    _, jmets = jtrain.make_train_step(jm, jt)(jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert math.isnan(float(jmets["loss"])) and math.isnan(float(jmets["grad_norm"]))


def test_a_mesh_is_the_multi_device_slice(tmp_path):
    """Where the JAX package takes a mesh the steps take a data group
    (parallel/dist.py); on one gloo rank the all-reduced step and the
    full eval step equal the steps without a group bit for bit.
    tests/test_torch_dp.py runs them on 2 and 4 ranks."""
    from deepdenoiser_tpu_torch.parallel import dist

    m, t = factory.ModelConfig(**TINY_KPN), config.TrainConfig(warmup_steps=0, ema_decay=0.9)
    data = config.DataConfig(mode="joint")
    batch = {k: torch.from_numpy(v) for k, v in _batch(TINY_KPN).items()}
    raw = {k: torch.from_numpy(v) for k, v in _raw_joint_batch().items()}
    threads = torch.get_num_threads()
    group = dist.init(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cpu")
    try:
        outs = []
        for grp in (None, group):
            state = train.create_state(m, t, seed=5, device="cpu")
            state, mets = train.make_train_step(m, t, grp)(state, batch)
            emets = train.make_full_eval_step(m, data, t.loss, grp)(state, raw)
            outs.append(({k: float(v) for k, v in {**mets, **emets}.items()},
                         _flat_params(state), _flat_ema(state)))
    finally:
        dist.shutdown(group)
        torch.set_num_threads(threads)
    assert outs[0][0] == outs[1][0]
    for want, got in zip(outs[0][1:], outs[1][1:]):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_create_state_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create_state runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.create_state(factory.ModelConfig(**TINY_UNET), config.TrainConfig())


# ---------------------------------------------------------------------------
# initialisation and remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-hq", "tiramisu-fast", "unet-multiscale",
                                    "flagship"])
def test_init_follows_flax_statistics(preset):
    """lecun-normal conv kernels (std 1/sqrt(fan_in), cut at two standard
    deviations of the untruncated normal), zero biases, a zero head for
    residual models, kernel_temp at t0: the JAX init_params tree's names,
    shapes and statistics."""
    mcfg = config.validate_channels(config.PRESETS[preset]).model
    jmcfg = jconfig.PRESETS[preset].model
    jmcfg = dataclasses.replace(jmcfg, in_channels=mcfg.in_channels, out_channels=mcfg.out_channels)
    m = factory.init_model(mcfg, torch.Generator().manual_seed(0))
    got = _flat_params(train.TrainState(0, m, None, None, None))
    spatial = factory.spatial_multiple(mcfg)
    want = weights_io.flatten(jax.tree.map(lambda s: np.array(s.shape), jax.eval_shape(
        lambda: jfactory.init_params(jmcfg, jax.random.PRNGKey(0), spatial=spatial))))
    assert {k: v.shape for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    residual_head = mcfg.predict_residual and not mcfg.kernel_prediction
    for k, v in got.items():
        if k.endswith("/bias") or (residual_head and k.split("/")[-2:] == ["Conv_0", "kernel"]
                                   and k.count("/") == 3):
            assert not v.any(), k
        elif k.endswith("kernel_temp"):
            np.testing.assert_allclose(v, math.log(3.0 / 13.0), rtol=1e-6)
        else:
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            std = 1.0 / math.sqrt(fan_in)
            assert np.abs(v).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6), k
            if v.size >= 2000:
                assert abs(v.std() / std - 1) < 0.1, (k, v.std(), std)
                assert abs(v.mean()) < 0.1 * std, k


def test_init_draws_from_the_generator():
    mcfg = factory.ModelConfig(**TINY_KPN)
    a = factory.init_model(mcfg, torch.Generator().manual_seed(1)).state_dict()
    b = factory.init_model(mcfg, torch.Generator().manual_seed(1)).state_dict()
    c = factory.init_model(mcfg, torch.Generator().manual_seed(2)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["UNet_0.ConvStack_0.ConvBlock_0.Conv_0.weight"],
                           c["UNet_0.ConvStack_0.ConvBlock_0.Conv_0.weight"])


def test_remat_equals_plain():
    mkw = dict(TINY_KPN, depth=2, convs_per_level=2)
    plain = factory.init_model(factory.ModelConfig(**mkw), torch.Generator().manual_seed(0))
    remat = factory.build_model(factory.ModelConfig(**mkw, remat=True))
    remat.load_state_dict(plain.state_dict())
    assert list(remat.state_dict()) == list(plain.state_dict())
    x = torch.from_numpy(_batch(mkw, n=2, s=16)["x"])
    grads = []
    for model in (plain, remat):
        out = model(x)
        (out * out).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        with torch.no_grad():
            torch.testing.assert_close(model(x), plain(x), rtol=0, atol=0)
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# eval steps
# ---------------------------------------------------------------------------


def _raw_joint_batch(seed=3, n=2, s=32):
    """A raw batch as the loader hands it over: '<role>/<pass>' crops in
    their stored dtypes."""
    from deepdenoiser_tpu_torch import passes
    from deepdenoiser_tpu_torch.data import prepare, shards, synthetic

    clean = synthetic.generate_clean_passes(s, s, seed=seed)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=seed + 1)
    raw = {}
    for role, d, names in (("source", noisy, prepare.default_source_passes()),
                           ("target", clean, prepare.default_target_passes())):
        for p in names:
            a = np.stack([d[p]] * n)
            raw[f"{role}/{p}"] = a.astype(shards._disk_dtype(p))
    del passes
    return raw


def test_full_eval_step_matches_jax():
    mkw = TINY_KPN
    data = config.DataConfig(mode="joint")
    jm, m = jfactory.ModelConfig(**mkw), factory.ModelConfig(**mkw)
    t, jt = config.TrainConfig(ema_decay=0.9), jconfig.TrainConfig(ema_decay=0.9)
    jstate = jtrain.create_state(jm, jt, jax.random.PRNGKey(0), spatial=16)
    state = train.create_state(m, t, device="cpu", params=_np(jstate.params))
    raw = _raw_joint_batch()
    want = jtrain.make_full_eval_step(jm, jconfig.DataConfig(mode="joint"), jt.loss)(
        jstate, {k: jnp.asarray(v) for k, v in raw.items()})
    got = train.make_full_eval_step(m, data, t.loss)(state, {k: torch.from_numpy(v)
                                                            for k, v in raw.items()})
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=REL), k


def test_eval_step_and_preview():
    mkw = TINY_KPN
    data = config.DataConfig(mode="joint")
    m, t = factory.ModelConfig(**mkw), config.TrainConfig(ema_decay=0.9)
    state = train.create_state(m, t, device="cpu")
    raw = {k: torch.from_numpy(v) for k, v in _raw_joint_batch(n=3).items()}
    batch = loader.make_batch_encoder(data)(raw)
    for use_ema in (False, True):
        mets = train.make_eval_step(m, t.loss, use_ema=use_ema)(state, batch)
        assert set(mets) == {"loss", "psnr_encoded"} and math.isfinite(float(mets["loss"]))
    noisy, den, gt = train.make_eval_preview(m, data, max_images=2)(state, raw)
    assert noisy.shape == den.shape == gt.shape == (2, 32, 32, 3)
    assert jloader.output_channels(jconfig.DataConfig(mode="joint")) == 24
