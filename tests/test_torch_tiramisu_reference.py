"""The benchmark's plain FC-DenseNet reference (h100_bench/reference/
tiramisu.py) against the port's tiramisu, and the port's dense-block spans
and concatenation counts, on the CPU; no JAX.

The reference and the port agree at fp32 within a relative L2 gap of 1e-5:
two float32 computations of the same convolutions on the CPU, which may
differ only in memory format (the port's channels_last) and thread count,
and so in the order of each conv's reductions (they read 0 here). Faults
read far above it: one dense layer's bias left at zero 7.7e-3 on the
backbone's output, max pooling in place of average 1.6e-1.
Nets: `tiramisu-lt1` at its published widths with seeded random weights
(every bias and the head nonzero), and a narrow net (growth 4, 2 layers a
block, depth 2) with uncompressed joins. Frames 48 x 64.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config, tracing, weights_io
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, tiramisu
from h100_bench import counts, traffic
from h100_bench.reference import frame as ref_frame
from h100_bench.reference import tiramisu as ref

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
H, W = 48, 64
REL_L2 = 1e-5  # fp32 on the CPU, reduction order (see above)
NARROW = {"growth_rate": 4, "layers_per_block": 2, "depth": 2, "up_compress": 0, "layers_top": 0}
NETS = {"tiramisu-lt1": {}, "narrow": NARROW}


def _cfg(net, dtype="float32"):
    exp = config.validate_channels(config.PRESETS["tiramisu-lt1"])
    return dataclasses.replace(exp.model, compute_dtype=dtype, **NETS[net])


def _random_model(cfg, seed=0):
    """The port's model with every parameter drawn from the seed: kernels
    at 1/sqrt(fan in), biases at 0.1."""
    model = factory.build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            fan_in = int(np.prod(p.shape[1:])) if p.ndim == 4 else 100
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    return model.eval()


def _gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("net", sorted(NETS))
def test_reference_matches_the_port_at_fp32(net, tmp_path):
    cfg = _cfg(net)
    model = _random_model(cfg)
    path = tmp_path / "w.npz"
    weights_io.save_release_params(path, weights_io.params_from_state_dict(model.state_dict()),
                                   dtype=np.float32)
    p = ref.to_device(ref.load_params(path), CPU)
    x = torch.randn((1, H, W, cfg.in_channels), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.network(p, x, config.to_dict(cfg))
        got = model(x)
    assert got.shape == want.shape == (1, H, W, 24)
    assert _gap(got, want) < REL_L2
    # the backbone alone, so that the residual's signal cannot hide it
    sig = ref.signal(config.to_dict(cfg), x)
    assert _gap(got - sig, want - sig) < REL_L2


@pytest.mark.parametrize("infer", [{}, {"tile": 32, "tile_batch": 2}], ids=["whole", "tiled"])
def test_reference_frame_matches_the_joint_frame_denoiser(infer):
    d = json.loads((REPO / "h100_bench" / "configs" / "tiramisu-lt1.json").read_text())
    weights = REPO / d.pop("bench")["weights"]
    exp = config.from_dict(config.ExperimentConfig, d)
    model_cfg = dataclasses.replace(exp.model, compute_dtype="float32")
    icfg = dataclasses.replace(exp.infer, compute_dtype="float32", stitch="exact", **infer)
    denoise, _ = pipeline.make_joint_frame_denoiser(
        model_cfg, icfg, H, W, weights_io.load_release_params(weights), device="cpu")
    frame = traffic.frames({"pool": 1, "height": H, "width": W, "spp": 4}, 2**31 + 7, CPU)[0]
    out = denoise(frame)
    p = ref.to_device(ref.load_params(weights), CPU)
    cert = ref.halo(d["model"])
    halo = ref_frame.plane_halo(dataclasses.asdict(icfg), cert, 8)
    want = ref_frame.denoise(lambda x: ref.network(p, x, d["model"]), frame, "joint", halo,
                             -(-cert // 8) * 8, 8, 10_000)
    assert len(want) == 9
    for k, r in want.items():
        assert _gap(out[k], r) < REL_L2, k


@pytest.mark.parametrize("net", ["tiramisu", "tiramisu-fast", "tiramisu-lt1", "narrow"])
def test_halo_equals_the_programs_rf_state(net):
    if net in NETS:
        cfg = _cfg(net)
    else:
        cfg = config.validate_channels(config.PRESETS[net]).model
    spec = factory._backbone_spec(cfg)
    assert ref.halo(config.to_dict(cfg)) == spec.rf_state().halo == factory.halo(cfg)


def _concat_rows(cfg, n, h, w):
    rows = counts.count_network(config.to_dict(cfg), n, h, w)
    return [r for r in rows if r.kind == "concat" and r.name != "signal gather"]


@pytest.mark.parametrize("net,dtype", [("tiramisu-lt1", "bfloat16"), ("narrow", "float32")])
def test_one_forward_counts_the_counters_backbone_concats(net, dtype):
    cfg = _cfg(net, dtype)
    model = factory.build_model(cfg).eval()
    tiramisu.reset_concats()
    with torch.no_grad():
        model(torch.zeros((2, H, W, cfg.in_channels)))
    rows = _concat_rows(cfg, 2, H, W)
    assert tiramisu.concats == len(rows) == (30 if net == "tiramisu-lt1" else 17)
    assert tiramisu.concat_bytes == sum(r.bytes_written for r in rows)
    tiramisu.reset_concats()
    assert tiramisu.concats == tiramisu.concat_bytes == 0


def test_a_unet_leaves_the_counters_unmoved():
    cfg = dataclasses.replace(config.validate_channels(config.PRESETS["kpn-hq"]).model,
                              base_width=8, depth=2, compute_dtype="float32")
    tiramisu.reset_concats()
    with torch.no_grad():
        factory.build_model(cfg).eval()(torch.zeros((1, H, W, cfg.in_channels)))
    assert tiramisu.concats == tiramisu.concat_bytes == 0


def test_dense_and_transition_spans_nest_under_backbone_and_cost_nothing_when_off():
    cfg = _cfg("narrow")
    model = factory.build_model(cfg).eval()
    x = torch.zeros((1, H, W, cfg.in_channels))
    tracing.disable()
    tracing.take()
    with torch.no_grad():
        off = model(x)
    assert tracing.take() == []
    tracing.enable()
    try:
        with torch.no_grad():
            on = model(x)
    finally:
        tracing.disable()
    spans = tracing.take()
    assert torch.equal(on, off)
    by_id = {s.id: s for s in spans}
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    depth = NARROW["depth"]
    assert names.count("dense") == 2 * depth + 1 and names.count("transition") == 2 * depth
    assert names[:2] == ["backbone", "dense"] and names[-1] == "head"
    for s in spans:
        if s.name in ("dense", "transition"):
            assert by_id[s.parent].name == "backbone"
