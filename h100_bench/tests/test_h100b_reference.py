"""The frozen copies agree with the program at the commit they were copied
from: the traffic generator draw for draw, the plain frame reference with
the program's frame denoisers (joint, group with the fused ingest's plain
version, tiled) in float32, the plain training steps with the program's
train step in float32. Small sizes, on the CPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from h100_bench import traffic
from h100_bench.drivers import train as train_driver
from h100_bench.reference import frame as ref_frame
from h100_bench.reference import train as ref_train
from h100_bench.reference import unet
from h100_bench.tests.conftest import BENCH, REPO

CPU = torch.device("cpu")


def _exp(name, **infer):
    from deepdenoiser_tpu_torch import config

    d = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    weights = REPO / d.pop("bench")["weights"]
    exp = config.from_dict(config.ExperimentConfig, d)
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, compute_dtype="float32"),
                              infer=dataclasses.replace(exp.infer, compute_dtype="float32", **infer))
    return exp, weights


def test_traffic_draws_the_programs_frames_and_batches():
    from deepdenoiser_tpu_torch.data import synthetic_device as sd
    from deepdenoiser_tpu_torch.data.draws import Draws

    ours = traffic.Draws(torch.Generator().manual_seed(5))
    theirs = Draws(torch.Generator().manual_seed(5))
    a = traffic.add_mc_noise(ours, traffic.generate_clean_passes(ours, 2, 24, 40), 4)
    b = sd.add_mc_noise(theirs, sd.generate_clean_passes(theirs, 2, 24, 40), 4)
    assert sorted(a) == sorted(b) and len(a) == 18
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for mode in ("joint", "group"):
        x = traffic.training_batch(traffic.Draws(torch.Generator().manual_seed(9)), 3, 32, mode)
        y = sd.training_batch(torch.Generator().manual_seed(9), 3, 32, mode, "fourier")
        assert torch.equal(x["x"], y["x"]) and torch.equal(x["y"], y["y"])


def test_same_seed_same_frames_and_large_seeds_work():
    p = {"pool": 2, "height": 16, "width": 24, "spp": 4}
    a, b = traffic.frames(p, 2**31 + 12345, CPU), traffic.frames(p, 2**31 + 12345, CPU)
    c = traffic.frames(p, 7, CPU)
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])
    assert not torch.equal(a[0]["diffuse_direct"], c[0]["diffuse_direct"])


@pytest.mark.parametrize("name,infer,hw", [
    ("kpn-hq", {}, (40, 56)),
    ("flagship-max", {"use_pallas_ingest": True}, (40, 56)),
    ("kpn-hq", {"tile": 16, "tile_batch": 3}, (40, 56)),
])
def test_frame_reference_matches_the_programs_frame_denoiser_in_float32(name, infer, hw):
    from deepdenoiser_tpu_torch import weights_io
    from deepdenoiser_tpu_torch.inference import pipeline

    exp, weights = _exp(name, **infer)
    make = {"joint": pipeline.make_joint_frame_denoiser,
            "group": pipeline.make_group_frame_denoiser}[exp.data.mode]
    denoise, _ = make(exp.model, exp.infer, *hw, weights_io.load_release_params(weights), device="cpu")
    frame = traffic.frames({"pool": 1, "height": hw[0], "width": hw[1], "spp": 4}, 3, CPU)[0]
    out = denoise(frame)
    model = json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]
    p = unet.to_device(unet.load_params(weights), CPU)
    cert = unet.halo(model)
    halo = ref_frame.plane_halo(dataclasses.asdict(exp.infer), cert, 8)
    ref = ref_frame.denoise(lambda x: unet.network(p, x, model), frame, exp.data.mode, halo,
                            -(-cert // 8) * 8, 8, 10_000)
    assert len(ref) == 9
    for k, r in ref.items():
        gap = float((out[k] - r).norm() / r.norm())
        assert gap < 1e-5, (k, gap)


def test_banded_reference_equals_the_whole_plane():
    c = json.loads((BENCH / "configs" / "kpn-hq.json").read_text())
    model = c["model"]
    p = unet.to_device(unet.load_params(REPO / c["bench"]["weights"]), CPU)
    frame = traffic.frames({"pool": 1, "height": 200, "width": 48, "spp": 4}, 4, CPU)[0]
    cert = unet.halo(model)
    args = ("joint", 72, 72, 8)
    whole = ref_frame.denoise(lambda x: unet.network(p, x, model), frame, *args, 10_000)
    bands = ref_frame.denoise(lambda x: unet.network(p, x, model), frame, *args, 64)
    assert cert <= 72
    for k in whole:
        assert float((whole[k] - bands[k]).abs().max() / whole[k].abs().max()) < 1e-5, k


def test_training_reference_matches_the_programs_step_in_float32():
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.training import train as train_lib

    d = json.loads((BENCH / "configs" / "kpn-hq.json").read_text())
    recipe = json.loads((BENCH / "traffic" / "train-recipe-b16.json").read_text())["train"]
    weights = REPO / d.pop("bench")["weights"]
    d["train"] = {**d["train"], **recipe, "loss": {**d["train"]["loss"], **recipe["loss"],
                                                   "gradient_weight": 0.2}}
    d["train"]["warmup_steps"] = 1  # a learning rate above 0 from the second step
    d["model"]["compute_dtype"] = "float32"
    exp = config.from_dict(config.ExperimentConfig, d)
    shapes = {n: v.shape for n, v in unet.load_params(weights).items()}
    params0 = train_driver.init_params(shapes, 11, CPU)
    batches = traffic.train_batches({"batch": 2, "crop": 32, "pool": 3, "family": "fourier"}, 11,
                                    CPU, "joint")
    state = train_lib.create_state(exp.model, exp.train, device="cpu",
                                   params=train_driver._nested(params0))
    step = train_lib.make_train_step(exp.model, exp.train)
    losses, g1 = [], None
    for i, b in enumerate(batches):
        state, mets = step(state, b)
        losses.append(float(mets["loss"]))
        if i == 0:
            opt = state.optimizer.state
            g1 = {train_driver.flax_path(n): opt[p]["exp_avg"].detach().numpy().copy() / 0.1
                  for n, p in state.model.named_parameters()}
    params = unet.to_device(params0, CPU, requires_grad=True)
    res = ref_train.run_steps(lambda q, x: unet.network(q, x, d["model"]), params, d["train"], batches)
    np.testing.assert_allclose(losses, res["loss"], rtol=1e-5)
    for n, p in state.model.named_parameters():
        key = train_driver.flax_path(n)
        mine = p.detach().numpy()
        mine = mine.transpose(2, 3, 1, 0) if mine.ndim == 4 else mine
        delta_prog = mine - params0[key]
        delta_ref = params[key].detach().numpy() - params0[key]
        gp, gr = g1[key], res["grad1"][key].numpy()
        gp = gp.transpose(2, 3, 1, 0) if gp.ndim == 4 else gp
        assert np.linalg.norm(gp - gr) <= 1e-3 * np.linalg.norm(gr) + 1e-12, key
        assert np.linalg.norm(delta_prog - delta_ref) <= 1e-2 * np.linalg.norm(delta_ref) + 1e-9, key
