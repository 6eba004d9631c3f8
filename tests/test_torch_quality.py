"""Quality floors of the port, the twins of two JAX package tests:

* tests/test_pretrained.py::test_flagship_mc_denoises_traced_monte_carlo:
  the release flagship-mc weights through the port's joint pipeline gain
  more than 6 dB on a traced 160x160 frame (seed 31, GT 256 spp, noisy
  4 spp), made by the port's tracer and, passed in as numpy, by the JAX
  package's. fp32 here (the CPU computes bf16 convolutions slowly); on the
  traced 1080p frame the card's bf16 gain is held within 0.15 dB of fp32's
  by tests/test_torch_gpu.py::test_bf16_frame_gains_within_its_bar_of_fp32.
* tests/test_end_to_end_quality.py::test_training_beats_noisy_input: an
  rgb UNet (base 16, depth 2) trained from scratch for 300 steps on
  Fourier shards through the port's shard writer, loader and train step:
  the loss ends below 0.2x the first, and a held-out frame gains more
  than 3 dB.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu.data import mc_tracer as jmc
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.config import DataConfig, InferenceConfig, TrainConfig
from deepdenoiser_tpu_torch.data import loader, mc_tracer, prepare, shards, synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops import metrics
from deepdenoiser_tpu_torch.ops.losses import LossConfig
from deepdenoiser_tpu_torch.training import train
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
MC = 160


def _gain_db(out, noisy, clean) -> float:
    tm = metrics.tonemap_for_metrics
    ref = tm(torch.as_tensor(clean))[None]
    return float(metrics.psnr(tm(torch.as_tensor(out))[None], ref)
                 - metrics.psnr(tm(torch.as_tensor(noisy))[None], ref))


@pytest.fixture(scope="module")
def flagship_mc():
    cfg = config.validate_channels(config.PRESETS["flagship-mc"])
    params = weights_io.load_release_params(REPO / "weights" / "flagship_mc_ema_f16.npz")
    infer = InferenceConfig(tile=0, border=cfg.infer.border, compute_dtype="float32")
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, infer, MC, MC, params, device="cpu")
    return den


def _port_frame():
    clean = mc_tracer.generate_clean_passes(MC, MC, seed=31, spp=256, device="cpu")
    noisy = mc_tracer.generate_noisy_passes(MC, MC, seed=31, spp=4, device="cpu")
    return clean, noisy


def _jax_frame():
    clean = jmc.generate_clean_passes(MC, MC, seed=31, spp=256)
    noisy = jmc.generate_noisy_passes(MC, MC, seed=31, spp=4)
    return ({k: np.array(v) for k, v in clean.items()},  # writable copies for torch
            {k: np.array(v) for k, v in noisy.items()})


@pytest.mark.parametrize("tracer", [_port_frame, _jax_frame], ids=["port-traced", "jax-traced"])
def test_flagship_mc_denoises_traced_monte_carlo(flagship_mc, tracer):
    clean, noisy = tracer()
    out = flagship_mc(noisy)["combined"]
    assert torch.isfinite(out).all()
    gain = _gain_db(out, noisy["combined"], clean["combined"])
    assert gain > 6.0, gain


def _build_shards(root: Path, dcfg: DataConfig) -> None:
    src_p, tgt_p = prepare.default_source_passes(), prepare.default_target_passes()
    w = shards.ShardWriter(root, dcfg.crop, src_p, tgt_p, 256)
    rng = np.random.default_rng(0)
    for f in range(6):
        clean, noisies = synthetic.generate_frame_set(96, 96, seed=f, spps=(4,), n_seeds=1)
        for noisy in noisies:
            for _ in range(dcfg.crops_per_frame):
                y, x = rng.integers(0, 96 - dcfg.crop, 2)
                w.add({k: v[y:y + dcfg.crop, x:x + dcfg.crop] for k, v in noisy.items()},
                      {k: clean[k][y:y + dcfg.crop, x:x + dcfg.crop] for k in tgt_p})
    w.finalize()


def test_training_beats_noisy_input(tmp_path):
    dcfg = DataConfig(crop=32, crops_per_frame=24, batch_size=16, mode="rgb", seed=0)
    _build_shards(tmp_path / "train", dcfg)
    mcfg = ModelConfig(backbone="unet", in_channels=config.input_channels(dcfg), out_channels=3,
                       base_width=16, depth=2, convs_per_level=1, act="relu")
    tcfg = TrainConfig(steps=300, warmup_steps=20, learning_rate=3e-3, schedule="constant",
                       loss=LossConfig(kind="l1", gradient_weight=0.2))
    encode = loader.make_batch_encoder(dcfg)
    state = train.create_state(mcfg, tcfg, seed=0, device="cpu")
    step = train.make_train_step(mcfg, tcfg)
    it = loader.make_iterator(tmp_path / "train", dcfg, training=True)
    try:
        losses = []
        for _ in range(300):
            state, mets = step(state, encode(next(it)))
            losses.append(float(mets["loss"]))
    finally:
        it.close()
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])

    clean = synthetic.generate_clean_passes(96, 96, seed=999)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=5)
    params = weights_io.params_from_state_dict(state.model.state_dict())
    den, _ = pipeline.make_rgb_frame_denoiser(
        mcfg, InferenceConfig(tile=0, compute_dtype="float32"), 96, 96, params, device="cpu")
    out = den(noisy)["combined"]
    gain = _gain_db(out, noisy["combined"], clean["combined"])
    assert gain > 3.0, gain
