"""The port's roofline counter and tools (deepdenoiser_tpu_torch/tools/
roofline.py, traffic_breakdown.py) on the CPU.

count_network's FLOPs against XLA's cost_analysis() of the JAX model of the
same config at 64x96 (the number the JAX roofline reads); its conv rows
against the FLOPs of every F.conv2d call of a CPU forward, exactly; K1's
and the group encode's bytes at the path shapes PERF.md's kernel table
gives; the reports' keys, with every device metric null on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, kpn
from deepdenoiser_tpu_torch.ops import kpn_apply
from deepdenoiser_tpu_torch.tools import eval_zoo, roofline, traffic_breakdown
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS
from tools.pretrain_flagship import MODELS as JMODELS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, W = 64, 96
# The UNet presets: the convs are 98-99 % of XLA's FLOPs, and the counter
# adds the bias, activation and head rows. multiscale reads 0.7 % over: its
# pyramid and composition are counted per element here, not as XLA's
# fusions, and 3 % still catches a left-out scale (its coarsest network is
# about 5 % of the FLOPs). tiramisu-lt1's 16-channel dense layers leave a
# larger share to XLA's elementwise and reduce-window accounting at 64x96
# (convs alone read 11.8 % under; the counter 10.2 %): 15 %.
FLOP_TOL = {"kpn-hq": 0.03, "flagship-hq": 0.03, "flagship": 0.03, "kpn": 0.03,
            "multiscale": 0.03, "tiramisu-lt1": 0.15}
JAX_KEYS = ("model", "resolution", "latency_ms", "gflops_per_frame", "hbm_gb_per_frame",
            "arithmetic_intensity", "ridge_point", "achieved_tflops", "mfu", "achieved_hbm_gbps",
            "hbm_utilization", "bound", "speed_of_light_ms", "sol_compute_ms", "sol_hbm_ms")
DEVICE_TIMED = ("latency_ms", "achieved_tflops", "mfu", "achieved_hbm_gbps", "hbm_utilization")
CPU = torch.device("cpu")


def _flops(rows, kind=None):
    return sum(r.flops for r in rows if kind is None or r.kind == kind)


@pytest.mark.parametrize("model", sorted(FLOP_TOL))
def test_network_flops_match_xla_cost_analysis(model):
    mcfg = JMODELS[model]
    params = jfactory.init_params(mcfg, jax.random.PRNGKey(0), spatial=64)
    net = jfactory.build_model(mcfg)
    x = jnp.zeros((1, H, W, mcfg.in_channels), jnp.float32)
    ca = jax.jit(net.apply).lower(params, x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    want = float(ca["flops"])
    got = _flops(roofline.count_network(MODELS[model], 1, H, W))
    assert abs(got / want - 1) <= FLOP_TOL[model], (model, got, want)


class _ConvFlops:
    """Wraps F.conv2d and sums 2*N*Ho*Wo*Co*(Ci/groups)*kh*kw of each call;
    a resize-conv's 2x2 sub-pixel call (4F outputs on (H+1)x(W+1) coarse
    positions) counts the function it computes, the 3x3 conv of F outputs
    over the (2H, 2W) resized input, as the counter's row does (the
    model's FLOPs, which XLA counts for the JAX sub-pixel conv)."""

    def __init__(self, monkeypatch):
        self.flops, self.calls = 0, 0
        real = F.conv2d

        def counted(x, weight, *a, **kw):
            y = real(x, weight, *a, **kw)
            co, ci, kh, kw_ = weight.shape
            ho, wo = y.shape[2], y.shape[3]
            if (kh, kw_) == (2, 2):
                co, ho, wo, kh, kw_ = co // 4, 2 * (ho - 1), 2 * (wo - 1), 3, 3
            self.flops += 2 * y.shape[0] * ho * wo * co * ci * kh * kw_
            self.calls += 1
            return y

        monkeypatch.setattr(F, "conv2d", counted)


CONV_MODELS = ["kpn-hq", "flagship-hq", "flagship", "kpn", "rgb-small", "tiramisu-lt1",
               "tiramisu", "tiramisu-s2d", "multiscale", "kpn-joint-s2d"]


@pytest.mark.parametrize("model", CONV_MODELS)
def test_conv_rows_equal_the_conv2d_calls_of_a_forward(model, monkeypatch):
    mcfg = MODELS[model]
    net = factory.build_model(mcfg).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, H, W, mcfg.in_channels), dtype=np.float32))
    conv = _ConvFlops(monkeypatch)
    with torch.no_grad():
        net(x)
    rows = roofline.count_network(mcfg, 2, H, W)
    assert conv.calls == sum(r.kind == "conv" for r in rows)
    assert conv.flops == _flops(rows, "conv")


@pytest.mark.parametrize("model,infer_kw", [
    ("kpn-hq", dict(border=8)),
    ("kpn-hq", dict(tile=32, tile_batch=3)),  # lazy chunks, the last one wrapped
    ("kpn", dict(border=8, use_pallas_ingest=True)),  # group: the groups as one batch
    ("kpn", dict(tile=32, tile_batch=5)),  # group tiles, zero-padded to the batch
])
def test_frame_conv_rows_equal_the_conv2d_calls_of_a_frame(model, infer_kw, monkeypatch):
    mcfg = MODELS[model]
    icfg = InferenceConfig(compute_dtype="float32", **infer_kw)
    h, w = 40, 56
    den, _ = getattr(pipeline, f"make_{roofline._mode(mcfg)}_frame_denoiser")(
        mcfg, icfg, h, w, eval_zoo.init_params(mcfg), device=CPU)
    frame = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=0), spp=4, seed=1)
    conv = _ConvFlops(monkeypatch)
    den(frame)
    rows = roofline.count_frame(mcfg, icfg, h, w)
    assert conv.calls == sum(r.calls for r in rows if r.kind == "conv")
    assert conv.flops == _flops(rows, "conv")
    assert {r.stage for r in rows} == {"encode", "pad", "model", "crop", "decode"}


@pytest.mark.parametrize("shape,mb", [((1, 1144, 1984), 281.4), ((4, 1144, 1984), 1125.8),
                                      ((8, 656, 656), 426.9), ((16, 96, 96), 18.3)])
def test_k1_bytes_at_the_path_shapes(shape, mb):
    row = roofline.count_kpn_apply(*shape)
    assert round(row.bytes / 1e6, 1) == mb
    assert row.bytes == 124 * int(np.prod(shape)) and row.flops == 150 * int(np.prod(shape))


def test_frames_count_k1_and_the_group_encode_at_their_shapes():
    kpn_hq, group = MODELS["kpn-hq"], MODELS["kpn"]
    whole = roofline.count_frame(kpn_hq, InferenceConfig(border=32), 1080, 1920)
    k1 = [r for r in whole if r.kind == "kpn_apply"]
    assert len(k1) == 8 and all(r.bytes == roofline.count_kpn_apply(1, 1144, 1984).bytes
                                for r in k1)
    uhd = roofline.count_frame(kpn_hq, InferenceConfig(tile=512, tile_batch=8), 2160, 3840)
    k1 = [r for r in uhd if r.kind == "kpn_apply"]
    assert len(k1) == 8 and {r.calls for r in k1} == {5}  # 40 launches of (8, 656, 656)
    assert all(r.bytes == 5 * roofline.count_kpn_apply(8, 656, 656).bytes for r in k1)
    rows = roofline.count_frame(group, InferenceConfig(border=32, use_pallas_ingest=True),
                                1080, 1920)
    enc = [r for r in rows if r.stage == "encode"]
    assert len(enc) == 1 and round(enc[0].bytes / 1e6, 1) == 804.6
    assert enc[0] == roofline.count_group_encode(4, 1080, 1920)
    k1 = [r for r in rows if r.kind == "kpn_apply"]
    assert len(k1) == 2 and all(r.bytes == roofline.count_kpn_apply(4, 1144, 1984).bytes
                                for r in k1)


def _last_json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_roofline_on_the_cpu_prints_counts_and_no_device_metric(capsys):
    assert roofline.main(["--model", "kpn-hq", "--height", "1080", "--width", "1920",
                          "--border", "32", "--device", "cpu"]) == 0
    rep = _last_json(capsys.readouterr().out)
    assert set(JAX_KEYS) <= set(rep) and {"device", "power_limit_w"} <= set(rep)
    assert all(rep[k] is None for k in DEVICE_TIMED)
    assert rep["device"] == "cpu" and rep["power_limit_w"] is None
    rows = roofline.count_frame(MODELS["kpn-hq"], InferenceConfig(border=32), 1080, 1920)
    assert rep["gflops_per_frame"] == round(_flops(rows) / 1e9, 1)
    # 1.8 MFLOP a pixel over the 1144x1984 plane: about 4.1 TFLOP a frame
    assert 3.9e3 < rep["gflops_per_frame"] < 4.4e3
    assert rep["ridge_point"] == round(989e12 / 3.35e12, 1)
    assert rep["speed_of_light_ms"] == max(rep["sol_compute_ms"], rep["sol_hbm_ms"])


def test_roofline_refuses_non_joint_models_and_needs_a_card_unless_told(monkeypatch):
    with pytest.raises(SystemExit):
        roofline.main(["--model", "kpn", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (roofline, traffic_breakdown):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--model", "kpn-hq"])


def test_report_divides_by_a_device_time():
    rows = roofline.count_frame(MODELS["flagship-hq"], InferenceConfig(border=32), 1080, 1920)
    rep = roofline.report("flagship-hq", 1080, 1920, rows, 0.030,
                          {"device": "card", "power_limit_w": 700.0})
    t = roofline.totals(rows)
    assert rep["mfu"] == round(t["flops"] / 0.030 / 989e12, 4)
    assert rep["hbm_utilization"] == round(t["bytes"] / 0.030 / 3.35e12, 4)
    assert 0 < rep["mfu"] <= 1 and rep["latency_ms"] == 30.0


def test_traffic_breakdown_on_the_cpu(capsys, monkeypatch, tmp_path):
    plain = kpn.apply_per_pixel_kernels

    def counted(noisy, weights, k):  # stands in for the card's launch count
        kpn_apply.launches += 1
        return plain(noisy, weights, k)

    monkeypatch.setattr(kpn, "apply_per_pixel_kernels", counted)
    out = tmp_path / "report.txt"
    assert traffic_breakdown.main(["--model", "kpn-hq", "--height", "48", "--width", "64",
                                   "--border", "16", "--top", "5", "--time", "--chain", "1",
                                   "--samples", "1", "--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert out.read_text().strip() == text.strip()
    rows = roofline.count_frame(MODELS["kpn-hq"], InferenceConfig(border=16), 48, 64)
    table = traffic_breakdown.stage_table(rows)
    assert [s for s, _, _ in table] == ["encode", "net", "decode+recompose", "FULL pipeline"]
    assert sum(f for _, f, _ in table[:3]) == table[3][1]
    assert sum(b for _, _, b in table[:3]) == table[3][2]
    ops = {ln.split()[0]: ln for ln in text.splitlines()[text.splitlines().index(
        "output-buffer bytes by op (one FULL frame):") + 1:] if ln.startswith("  aten.")
           or ln.startswith("  kpn_apply")}
    assert any("conv" in op for op in ops) and "aten.cat" in ops
    assert ops["kpn_apply"].rstrip().endswith("x8")
    assert "sum of stages" in text


def test_op_table_leaves_out_views_and_allocations():
    x = torch.ones(4, 8)
    with traffic_breakdown.OpBytes() as rec:
        y = x.t()[1:]  # views
        torch.empty(100)
        z = (y + 1).contiguous()  # a fresh output, and a copy of it
        z.add_(1)  # in place: writes
    assert set(rec.by_op) == {"aten.add", "aten.clone", "aten.add_"}
    assert all(v == [7 * 4 * 4, 1] for v in rec.by_op.values())
