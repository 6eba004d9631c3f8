"""The benchmark's plain multi-scale reference (h100_bench/reference/
multiscale.py) and seeded weights (h100_bench/seeded.py) against the
port's multi-scale UNet, and the wrapper's spans and counts, on the CPU;
no JAX.

The reference and the port agree at fp32 within a relative L2 gap of 1e-5:
two float32 computations of the same convolutions, pools and upsamples on
the CPU, which may differ only in memory format (the port's channels_last),
in how a 2x2 mean is summed, and so in the order of each reduction (they
read 7e-8 to 1e-7 here). Faults read far above it: the compose without its
`- down(pred)` term 2.1e-1 to 3.8e-1, a bilinear upsample in place of the
nearest 9.0e-2 to 9.7e-2 (depth 2 with 2 scales, depth 3 with 3).
Nets: seeded weights (the benchmark's recipe, every conv and the head
drawn) on narrow UNets (base 8, depth 2 or 3, 2 or 3 scales), and the
preset unet-multiscale at its published widths for the weights file, the
halo and the counts.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config, tracing, weights_io
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, multiscale
from h100_bench import seeded, traffic
from h100_bench.reference import frame as ref_frame
from h100_bench.reference import multiscale as ref
from h100_bench.reference import unet as ref_unet

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "h100_bench"
CPU = torch.device("cpu")
REL_L2 = 1e-5  # fp32 on the CPU, reduction order (see above)
GAIN, BIAS_STD = 1.2, 0.01  # the narrow nets' draw: the preset's recipe


def _preset():
    return config.validate_channels(config.PRESETS["unet-multiscale"])


def _narrow(depth, scales, dtype="float32"):
    return dataclasses.replace(_preset().model, base_width=8, depth=depth, n_scales=scales,
                               compute_dtype=dtype)


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


def _cell_config():
    d = json.loads((BENCH / "configs" / "unet-multiscale.json").read_text())
    bench = d.pop("bench")
    return d, bench


def test_the_config_file_is_the_preset_with_its_seeded_weights():
    d, bench = _cell_config()
    assert d == json.loads(json.dumps(config.to_dict(_preset())))  # as config.save writes it
    assert bench["reference"] == "multiscale"
    assert bench["weights"] == "h100_bench/weights/unet_multiscale_seeded_f16.npz"


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
        assert np.count_nonzero(g) > 0, k  # no conv all zero, the 1x1 head included
    assert "UNet_0/Conv_0/kernel" in want
    # the release format: the program reads it into the preset's model, every leaf
    model = factory.build_model(_preset().model)
    weights_io.load_into(model, weights_io.load_release_params(REPO / bench["weights"]))
    assert sum(p.numel() for p in model.parameters()) == 6_574_584


def test_seeded_network_term_is_a_tenth_to_once_the_signal():
    """The network's term, out - signal, against the 24 signal channels it
    is added to, by RMS, on a traffic frame at the preset's widths."""
    d, bench = _cell_config()
    p = ref.to_device(ref.load_params(REPO / bench["weights"]), CPU)
    frame = traffic.frames({"pool": 1, "height": 96, "width": 128, "spp": 4}, 2**33 + 5, CPU)[0]
    x = ref_frame.encode(frame, "joint")
    with torch.no_grad():
        y = ref.network(p, x, d["model"])
    sig = ref_unet.signal(d["model"], x)
    ratio = float((y - sig).pow(2).mean().sqrt() / sig.pow(2).mean().sqrt())
    assert 0.1 < ratio < 1.0, ratio


@pytest.mark.parametrize("depth,scales,hw", [(2, 2, (64, 96)), (2, 3, (96, 128)),
                                             (3, 2, (64, 160)), (3, 3, (128, 160))])
def test_reference_matches_the_port_at_fp32(depth, scales, hw, tmp_path):
    cfg = _narrow(depth, scales)
    path = _weights(cfg, tmp_path / "w.npz")
    model = _port(cfg, path)
    p = ref.to_device(ref.load_params(path), CPU)
    x = torch.randn((1, *hw, cfg.in_channels), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.network(p, x, config.to_dict(cfg))
        got = model(x)
    assert got.shape == want.shape == (1, *hw, 24)
    assert _gap(got, want) < REL_L2
    # the backbone alone, so that the residual's signal cannot hide it
    sig = ref_unet.signal(config.to_dict(cfg), x)
    assert _gap(got - sig, want - sig) < REL_L2


def test_reference_pads_to_the_multiple_and_crops_back(tmp_path):
    """A size the pyramid does not divide: the reference pads the bottom and
    right edges, and a pixel beyond the certified halo of the pad sees
    none of it."""
    cfg = _narrow(2, 3)
    md = config.to_dict(cfg)
    p = ref.to_device(ref.load_params(_weights(cfg, tmp_path / "w.npz")), CPU)
    x = torch.randn((1, 400, 144, cfg.in_channels), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        odd = ref.network(p, x[:, :390], md)
        whole = ref.network(p, x, md)
    assert odd.shape == (1, 390, 144, 24)
    keep = 390 - ref.halo(md) - 1  # rows whose field ends before the padded ones
    assert _gap(odd[:, :keep], whole[:, :keep]) < REL_L2


@pytest.mark.parametrize("infer", [{}, {"tile": 32, "tile_batch": 2}], ids=["whole", "tiled"])
def test_reference_frame_matches_the_joint_frame_denoiser(infer, tmp_path):
    """The frame through the program's joint frame denoiser against
    reference/frame.denoise driven as the benchmark's frames driver drives
    it: the plane's halo from `plane_halo(infer, halo(model), 2**depth)`,
    the context rounded to 2**depth."""
    h, w = 40, 56
    cfg = _narrow(2, 3)
    path = _weights(cfg, tmp_path / "w.npz")
    icfg = dataclasses.replace(_preset().infer, compute_dtype="float32", **infer)
    denoise, _ = pipeline.make_joint_frame_denoiser(
        cfg, icfg, h, w, weights_io.load_release_params(path), device="cpu")
    frame = traffic.frames({"pool": 1, "height": h, "width": w, "spp": 4}, 2**31 + 7, CPU)[0]
    out = denoise(frame)
    md = config.to_dict(cfg)
    p = ref.to_device(ref.load_params(path), CPU)
    cert, m = ref.halo(md), 2 ** md["depth"]
    halo = ref_frame.plane_halo(dataclasses.asdict(icfg), cert, m)
    want = ref_frame.denoise(lambda x: ref.network(p, x, md), frame, "joint", halo,
                             -(-cert // m) * m, m, 10_000)
    assert len(want) == 9
    for k, r in want.items():
        assert _gap(out[k], r) < REL_L2, k


@pytest.mark.parametrize("hw", [(1080, 1920), (2160, 3840)], ids=["1080p", "4k"])
def test_halo_is_the_programs_plan_and_its_bound_the_programs(hw):
    cfg = _preset()
    md = config.to_dict(cfg.model)
    assert ref.halo(md) == pipeline.plan_for(cfg.model, cfg.infer, *hw).halo == 288
    assert ref.certified_halo(md) == factory.halo(cfg.model) == 263
    assert ref.multiple(md) == factory.spatial_multiple(cfg.model) == 32


@pytest.mark.parametrize("depth,scales", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_certified_halo_is_the_programs_rf_state(depth, scales):
    cfg = _narrow(depth, scales)
    assert ref.certified_halo(config.to_dict(cfg)) == factory.halo(cfg)


def _glue_bytes(n, h, w, c_in, c_out, scales):
    """Bytes the pyramid's pools and the compose steps write, from shapes,
    all fp32: a pool writes a quarter of its input; a step at scale s
    writes down(pred) and the difference (a quarter each), the upsample and
    the sum (whole)."""
    pyramid = sum(n * (h >> s) * (w >> s) * c_in for s in range(1, scales))
    compose = sum(n * (h >> s) * (w >> s) * c_out * 5 // 2 for s in range(scales - 1))
    return 4 * (pyramid + compose)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_forward_counts_three_backbone_runs_and_the_glue_bytes(dtype):
    cfg = dataclasses.replace(_preset().model, compute_dtype=dtype)
    model = factory.build_model(cfg).eval()
    multiscale.reset_counts()
    with torch.no_grad():
        model(torch.zeros((2, 64, 96, cfg.in_channels)))
    assert multiscale.backbone_calls == 3
    assert multiscale.glue_bytes == _glue_bytes(2, 64, 96, 41, 24, 3)
    multiscale.reset_counts()
    assert multiscale.backbone_calls == multiscale.glue_bytes == 0


def test_a_frame_advances_the_counts_by_three_runs_and_its_planes_glue(tmp_path):
    h, w = 40, 56
    cfg = _narrow(2, 3)
    icfg = dataclasses.replace(_preset().infer, compute_dtype="float32")
    denoise, grid = pipeline.make_joint_frame_denoiser(
        cfg, icfg, h, w, weights_io.load_release_params(_weights(cfg, tmp_path / "w.npz")),
        device="cpu")
    frame = traffic.frames({"pool": 1, "height": h, "width": w, "spp": 4}, 11, CPU)[0]
    ph, pw = grid.tile_h + 2 * grid.halo, grid.tile_w + 2 * grid.halo
    multiscale.reset_counts()
    for frames in (1, 2):
        denoise(frame)
        assert multiscale.backbone_calls == 3 * frames
        assert multiscale.glue_bytes == frames * _glue_bytes(1, ph, pw, 41, 24, 3)


def test_a_single_scale_model_leaves_the_counts_unmoved():
    cfg = dataclasses.replace(_narrow(2, 3), n_scales=1)
    multiscale.reset_counts()
    with torch.no_grad():
        factory.build_model(cfg).eval()(torch.zeros((1, 32, 32, cfg.in_channels)))
    assert multiscale.backbone_calls == multiscale.glue_bytes == 0


def test_pyramid_scale_and_compose_spans_nest_under_backbone_and_cost_nothing_when_off():
    cfg = _narrow(2, 3)
    model = factory.build_model(cfg).eval()
    x = torch.randn((1, 32, 48, cfg.in_channels), generator=torch.Generator().manual_seed(3))
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
    assert names == ["backbone", "pyramid", "scale", "scale", "scale", "compose", "compose",
                     "head"]
    for s in spans:
        if s.name in ("pyramid", "scale", "compose"):
            assert by_id[s.parent].name == "backbone"
