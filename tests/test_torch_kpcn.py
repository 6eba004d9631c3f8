"""The KPCN of Bako et al. (models/kpcn.py) on the CPU: the port against the
benchmark's plain reference (h100_bench/reference/kpcn.py) on seeded
weights, one group frame through the program's frame denoiser against
reference/frame.denoise, the receptive field and the parameter tree, the
seeded weights file and its recipe, the counted figures of the cell
kpcn.1080p, the head's logit count and the k = 21 entry points' checks; no
JAX.

Tolerances. fp32: the port and the reference run the same float32 convs,
softmax and filter taps on the CPU and may differ only in memory format
(the port's channels_last) and so in the order of each reduction: a
relative L2 gap of 1e-5. bf16: the port rounds every conv's input, weights
and output to bfloat16 (8 significant bits) through 9 layers, then takes a
softmax over 441 logits, which turns a logit's rounding error into a
relative error of the weight: 5e-2 against the float32 reference (1.2e-2
read here at widths 8 and 16; 1.9e-2 to 2.5e-2 for the cell's frame at its
published widths on the CPU, where the float8 control reads 1.7e-1).
"""

import dataclasses
import hashlib
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config, tracing, weights_io
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, kpn
from deepdenoiser_tpu_torch.ops import kpn_apply, kpn_softmax
from h100_bench import counts, program, readers, registry, seeded, traffic
from h100_bench.reference import frame as ref_frame
from h100_bench.reference import kpcn as ref

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "h100_bench"
CPU = torch.device("cpu")
REL_L2 = 1e-5  # fp32 on the CPU, reduction order (see above)
BF16_REL_L2 = 5e-2  # bf16 through 9 convs and a 441-tap softmax (see above)
GAIN, BIAS_STD = 1.4, 0.01  # the narrow nets' draw: the configuration's recipe
CELL = "kpcn.1080p"


def _cell_config():
    d = json.loads((BENCH / "configs" / "kpcn.json").read_text())
    bench = d.pop("bench")
    return d, bench


def _cfg():
    d, _ = _cell_config()
    return config.from_dict(config.ExperimentConfig, d)


def _narrow(width, depth, dtype="float32"):
    return dataclasses.replace(_cfg().model, base_width=width, depth=depth, compute_dtype=dtype)


def _weights(cfg, path, seed=0):
    """The recipe's weights for `cfg`, written as a release file at `path`."""
    seeded.save(path, seeded.draw(config.to_dict(cfg), seed, GAIN, BIAS_STD))
    return path


def _port(cfg, path):
    model = factory.build_model(cfg)
    weights_io.load_into(model, weights_io.load_release_params(path))
    return model.eval()


def _gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_the_config_file_is_the_kpcn_as_config_save_writes_it():
    d, bench = _cell_config()
    cfg = _cfg()
    assert d == json.loads(json.dumps(config.to_dict(config.validate_channels(cfg))))
    m = cfg.model
    assert (m.backbone, m.base_width, m.depth, m.act, m.kpn_size, m.kpn_slots) == (
        "kpcn", 100, 9, "relu", 21, 2)
    assert m.kernel_prediction and not m.kpn_logit_norm and m.compute_dtype == "bfloat16"
    assert (cfg.data.mode, cfg.infer.border, cfg.infer.tile) == ("group", 32, 0)
    assert bench["reference"] == "kpcn"
    assert bench["weights"] == "h100_bench/weights/kpcn_seeded_f16.npz"


def test_seeded_weights_file_is_the_recipe_bit_for_bit():
    d, bench = _cell_config()
    recipe = dict(re.findall(r"(seed|gain|bias_std)=([0-9.e-]+)", bench["note"]))
    want = seeded.draw(d["model"], int(recipe["seed"]), float(recipe["gain"]),
                       float(recipe["bias_std"]))
    with np.load(REPO / bench["weights"]) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(f"params/{k}" for k in want)
    for k, v in want.items():
        g = got[f"params/{k}"]
        assert g.dtype == v.dtype == np.float16 and g.shape == v.shape, k
        assert np.array_equal(g.view(np.uint16), v.view(np.uint16)), k
    model = factory.build_model(_cfg().model)
    weights_io.load_into(model, weights_io.load_release_params(REPO / bench["weights"]))
    assert sum(p.numel() for p in model.parameters()) == (
        14 * 100 * 25 + 100 + 7 * (100 * 100 * 25 + 100) + 100 * 882 * 25 + 882)


def test_seeded_softmax_is_far_from_a_box_blur():
    """On a generated frame the mean over pixels of each slot's largest
    weight is at least 10/441: the comparison with the reference can tell
    the model from a 21x21 box blur (1/441 everywhere)."""
    d, bench = _cell_config()
    model = d["model"]
    p = ref.to_device(ref.load_params(REPO / bench["weights"]), CPU)
    frame = traffic.frames({"pool": 1, "height": 24, "width": 32, "spp": 4}, 2**33 + 5, CPU)[0]
    x = ref_frame.encode(frame, "group")
    y = x.permute(0, 3, 1, 2)
    convs = list(ref._convs(model, 14, 882))
    with torch.no_grad():
        for i, name in enumerate(convs):
            w = p[name + "/kernel"].permute(3, 2, 0, 1)
            y = torch.nn.functional.conv2d(y, w, p[name + "/bias"], padding=2)
            if i < len(convs) - 1:
                y = torch.relu(y)
                # the activations neither vanish nor blow up through the ReLU layers
                assert 0.3 < float(y.pow(2).mean().sqrt()) < 3.0, i
    logits = y.permute(0, 2, 3, 1)
    for s in range(2):
        top = torch.softmax(logits[..., 441 * s: 441 * (s + 1)], dim=-1).amax(dim=-1).mean()
        assert float(top) >= 10 / 441, (s, float(top) * 441)


@pytest.mark.parametrize("width,depth", [(8, 3), (16, 4)])
def test_reference_matches_the_port_at_fp32(width, depth, tmp_path):
    cfg = _narrow(width, depth)
    path = _weights(cfg, tmp_path / "w.npz")
    model = _port(cfg, path)
    p = ref.to_device(ref.load_params(path), CPU)
    x = torch.randn((4, 24, 32, cfg.in_channels), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.network(p, x, config.to_dict(cfg))
        got = model(x)
    assert got.shape == want.shape == (4, 24, 32, 6)
    assert _gap(got, want) < REL_L2
    # the filtered signal is no copy of the input: the kernels do work
    assert _gap(x[..., :6], want) > 0.1


@pytest.mark.parametrize("width,depth", [(8, 3), (16, 4)])
def test_reference_matches_the_port_at_bf16(width, depth, tmp_path):
    cfg = _narrow(width, depth, "bfloat16")
    path = _weights(cfg, tmp_path / "w.npz")
    model = _port(cfg, path)
    p = ref.to_device(ref.load_params(path), CPU)
    x = torch.randn((4, 24, 32, cfg.in_channels), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref.network(p, x, config.to_dict(cfg))
        feats = model.net(x)
        got = model(x)
    assert feats.dtype == torch.bfloat16 and feats.shape == (4, 24, 32, 882)
    assert got.dtype == torch.float32
    assert _gap(got, want) < BF16_REL_L2


def test_a_group_frame_matches_the_reference_frame(tmp_path):
    """One frame through make_group_frame_denoiser against
    reference/frame.denoise planned as the benchmark's frame runs plan
    it: the halo min(certified, border), the multiple 1, in two bands."""
    h, w = 20, 28
    cfg = _narrow(8, 3)
    path = _weights(cfg, tmp_path / "w.npz")
    icfg = dataclasses.replace(_cfg().infer, compute_dtype="float32")
    denoise, grid = pipeline.make_group_frame_denoiser(
        cfg, icfg, h, w, weights_io.load_release_params(path), device="cpu")
    md = config.to_dict(cfg)
    cert = ref.halo(md)
    assert cert == factory.halo(cfg) == 16 and grid.halo == 16
    frame = traffic.frames({"pool": 1, "height": h, "width": w, "spp": 4}, 2**31 + 7, CPU)[0]
    out = denoise(frame)
    p = ref.to_device(ref.load_params(path), CPU)
    halo = ref_frame.plane_halo(dataclasses.asdict(icfg), cert, 1)
    want = ref_frame.denoise(lambda x: ref.network(p, x, md), frame, "group", halo, cert, 1,
                             (h + 2 * halo) // 2)
    assert len(want) == 9
    for k, r in want.items():
        assert _gap(out[k], r) < REL_L2, k


def test_halo_multiple_and_parameters_are_the_references():
    cfg = _cfg()
    md = config.to_dict(cfg.model)
    assert factory.halo(cfg.model) == ref.halo(md) == 28
    assert factory.spatial_multiple(cfg.model) == ref.multiple(md) == 1
    assert factory.receptive_field(cfg.model) == 57
    g = pipeline.plan_for(cfg.model, cfg.infer, 1080, 1920)
    assert (g.halo, g.tile_h + 2 * g.halo, g.tile_w + 2 * g.halo) == (28, 1136, 1976)
    model = factory.build_model(cfg.model)
    got = {k: tuple(v.shape) for k, v in weights_io.flatten(
        weights_io.params_from_state_dict(model.state_dict())["params"]).items()}
    assert got == ref.param_shapes(md)
    assert sorted({k.split("/")[1] for k in got}) == [f"Conv_{i}" for i in range(9)]


def test_the_residual_init_zeroes_the_last_conv():
    cfg = dataclasses.replace(_narrow(8, 3), kernel_prediction=False, predict_residual=True)
    model = factory.init_model(cfg, torch.Generator().manual_seed(0))
    trunk = model.KPCN_0
    assert trunk.head is trunk.Conv_2 and not trunk.head.weight.any()
    assert trunk.Conv_0.weight.any()


# count_frame's FLOPs and bytes, whole_frame_flops, net_batch, certified halo,
# multiple, plan, the frame check's (halo, context, multiple), digest of every
# row of count_frame and of the network over net_batch
PINNED = (71761903415296, 232909857028, 71761903415296, (4, 1136, 1976), 28, 1,
          (1080, 1920, 1080, 1920, 28, 1, 1), (28, 28, 1), "d6a3d8b732405382")


def _digest(rows):
    return hashlib.sha256(repr([dataclasses.astuple(r) for r in rows]).encode()).hexdigest()[:16]


def test_the_cells_counted_figures_are_pinned():
    flops, nbytes, whole, batch, halo, m, grid, frame_plane, digest = PINNED
    cell = registry.load().cell(CELL)
    run = SimpleNamespace(cell=cell, info={"infer": program.settings(cell)["infer"]},
                          model=cell.config["model"])
    arch = readers.arch(run)
    h, w = readers.frame_hw(run)
    rows = counts.count_frame(run.model, run.info["infer"], h, w, arch.halo(run.model), arch=arch)
    t = counts.totals(rows)
    assert (t["flops"], t["bytes"]) == (flops, nbytes)
    assert readers.whole_frame_flops(run) == whole
    assert readers.net_batch(run) == batch
    assert readers.certified_halo(run) == halo
    assert arch.multiple(run.model) == m
    assert dataclasses.astuple(readers.plan(run)) == grid
    assert registry.driver("frames").plane(run.cell) == frame_plane
    net = counts.count_network(run.model, *batch, arch)
    assert _digest(rows + net) == digest
    convs = [r for r in net if r.kind == "conv"]
    assert [r.name for r in convs] == [f"KPCN_0/Conv_{i} conv5x5" for i in range(9)]
    assert sum(r.kind == "bias" for r in net) == 9 and sum(r.kind == "act" for r in net) == 8
    assert not [r for r in net if r.kind == "cast"]


def test_the_kpn_softmax_roofline_counts_bf16_logits_and_fp32_weights():
    cell = registry.load().cell(CELL)
    run = SimpleNamespace(cell=cell, info={"infer": program.settings(cell)["infer"]},
                          model=cell.config["model"], attempted=1, kernels=None)
    mod = registry.metric("kpn_softmax_roofline")
    assert mod.frame_bytes(run) == 2 * 4 * 1136 * 1976 * 441 * (2 + 4)
    assert mod.read(run) is None  # no trace, no share


def test_the_head_counts_the_logit_bytes_it_reads_at_their_dtype():
    cfg = _narrow(8, 3, "bfloat16")
    model = factory.build_model(cfg).eval()
    kpn.reset_counts()
    with torch.no_grad():
        model(torch.zeros((2, 10, 12, cfg.in_channels)))
    assert kpn.logit_bytes == 2 * 10 * 12 * 882 * 2
    with torch.no_grad():
        factory.build_model(dataclasses.replace(cfg, compute_dtype="float32")).eval()(
            torch.zeros((1, 10, 12, cfg.in_channels)))
    assert kpn.logit_bytes == 2 * 10 * 12 * 882 * 2 + 10 * 12 * 882 * 4
    kpn.reset_counts()
    assert kpn.logit_bytes == 0


def test_the_trunk_and_head_fall_in_the_backbone_head_and_k1_spans():
    cfg = _narrow(8, 3)
    model = factory.build_model(cfg).eval()
    tracing.disable()
    tracing.take()
    tracing.enable()
    try:
        with torch.no_grad():
            model(torch.zeros((1, 8, 8, cfg.in_channels)))
    finally:
        tracing.disable()
    names = [s.name for s in sorted(tracing.take(), key=lambda s: s.start_ns)]
    assert names == ["backbone", "head", "k1", "k1"]


def test_the_cpu_head_takes_bf16_logits_in_fp32():
    """KpnSoftmax on bf16 logits at k² = 441 computes in fp32 (the kernel's
    arithmetic), and its gradient reaches the bf16 logits."""
    gen = torch.Generator().manual_seed(3)
    feats = (2 * torch.randn((1, 3, 4, 882), generator=gen)).to(torch.bfloat16)
    logits = feats[..., 441:].requires_grad_()
    assert kpn_softmax.reads_in_place(logits)
    w = kpn_softmax.KpnSoftmax.apply(logits, None)
    assert w.dtype == torch.float32
    assert torch.equal(w, torch.softmax(logits.detach().float(), dim=-1))
    w.pow(2).sum().backward()
    assert logits.grad.dtype == torch.bfloat16 and logits.grad.abs().sum() > 0
    assert not kpn_softmax.reads_in_place(feats[..., :25])


@pytest.mark.parametrize("entry", ["bwd_weights_cuda", "bwd_noisy_cuda"])
def test_the_backward_refuses_k21_with_a_clear_message(entry):
    fn = getattr(kpn_apply, entry)
    a, b = torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3)
    if entry == "bwd_noisy_cuda":
        b = torch.zeros(1, 4, 4, 441)
    with pytest.raises(ValueError, match="kernel_size 21 .*no backward kernel"):
        fn(a, b, 21)


@pytest.mark.parametrize("make,err,match", [
    (lambda: (torch.randn(1, 4, 5, 882).to(torch.bfloat16)[..., :441], None), ValueError,
     "same CUDA device"),
    (lambda: (torch.randn(1, 4, 5, 50).to(torch.bfloat16)[..., :25], None), TypeError,
     "fp32 only"),
    (lambda: (torch.randn(1, 4, 5, 441).to(torch.float16), None), TypeError, "fp32 only"),
], ids=["bf16 at 441 passes to the device check", "bf16 at 25", "float16 at 441"])
def test_the_softmax_entry_takes_bf16_logits_only_at_441(make, err, match):
    kpn_softmax.reset_launches()
    with pytest.raises(err, match=match):
        kpn_softmax.softmax_cuda(*make())
    assert kpn_softmax.launches == 0


def test_the_forward_entry_takes_k21_up_to_the_device_check():
    with pytest.raises(ValueError, match="CUDA device"):
        kpn_apply.apply_cuda(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 441), 21)
    with pytest.raises(ValueError, match="kernel_size 7"):
        kpn_apply.apply_cuda(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 49), 7)


def test_the_padded_trunk_is_the_published_one(tmp_path):
    """The convs run at widths padded with zeros (14 -> 32, 100 -> 128, 882
    -> 888): the reference's function at the published widths (fp32: the
    padded channels add exact zeros; the sums may be taken in another
    order), the logits a view of the first 882 channels."""
    cfg = _narrow(100, 2)
    path = _weights(cfg, tmp_path / "w.npz")
    trunk = _port(cfg, path).KPCN_0
    assert trunk.run_widths == [32, 128, 888] and trunk.widths == [14, 100, 882]
    p = ref.to_device(ref.load_params(path), CPU)
    x = torch.randn((1, 12, 16, 14), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = trunk(x)
        want = torch.nn.functional.conv2d(torch.relu(torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), p["KPCN_0/Conv_0/kernel"].permute(3, 2, 0, 1),
            p["KPCN_0/Conv_0/bias"], padding=2)), p["KPCN_0/Conv_1/kernel"].permute(3, 2, 0, 1),
            p["KPCN_0/Conv_1/bias"], padding=2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 12, 16, 882) and got.stride(2) == 888
    assert _gap(got, want) < REL_L2


def test_the_padded_parameters_are_kept_until_a_parameter_changes():
    model = factory.init_model(_narrow(8, 2), torch.Generator().manual_seed(6)).eval()
    trunk = model.KPCN_0
    with torch.no_grad():
        first = trunk._pad_params()
        assert trunk._pad_params() is first
        trunk.Conv_1.bias.add_(1.0)
        again = trunk._pad_params()
    assert again is not first and torch.equal(again[1][1][:882], trunk.Conv_1.bias)
    assert not again[1][1][882:].any() and not again[0][0][8:].any()
