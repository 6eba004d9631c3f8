"""The configuration's reference module is the one place that describes its
architecture to the harness: the plane's multiple, the counted backbone and
the seeded parameters' shapes. The five cells' counted figures are pinned
to what the harness gave before the modules took these over, and an
architecture the harness has never seen is validated, counted, planned and
seeded from a module written as a new file."""

import dataclasses
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100_bench import counts, program, readers, registry, seeded
from h100_bench.reference import tiramisu, unet
from h100_bench.tests.conftest import BENCH, REPO, make_small

# cell -> (count_frame's FLOPs and bytes at the cell's infer, whole_frame_flops,
# net_batch, certified halo, multiple, plan, the frames driver's (halo, context,
# multiple), digest of every row of count_frame and of the network over net_batch)
PINNED = {
    "kpn-hq.1080p": (4110026280960, 42069831184, 4110026280960, (1, 1144, 1984), 67, 8,
                     (1080, 1920, 1080, 1920, 32, 1, 1), (32, 72, 8), "9d412aeba5765f1e"),
    "flagship-max.1080p": (9022263762944, 87895390532, 9022263762944, (4, 1144, 1984), 67, 8,
                           (1080, 1920, 1080, 1920, 32, 1, 1), (32, 72, 8), "17cb469478dce50f"),
    "kpn-hq.4k-tiled": (31168387891200, 315414458000, 15722601922560, (40, 656, 656), 67, 8,
                        (2160, 3840, 512, 512, 72, 5, 8), (72, 72, 8), "13e34cacd3936ec2"),
    "tiramisu-lt1.1080p": (795255566848, 23134041792, 795255566848, (1, 1144, 1984), 97, 8,
                           (1080, 1920, 1080, 1920, 32, 1, 1), (32, 104, 8), "4af184c85910bcfe"),
    # The frames driver's multiple was 2**depth = 8, which left the reference's
    # plane at 1656 rows and `network` padding 8 zero rows, 288 past the frame;
    # it is the module's multiple, 32, since: the program's own 1664-row plane.
    "unet-multiscale.1080p": (5527504481280, 51629955504, 5527504481280, (1, 1664, 2496), 288, 32,
                              (1080, 1920, 1088, 1920, 288, 1, 1), (288, 288, 32),
                              "2a6d85e94fd424b3"),
}


def _run(bench, name):
    cell = bench.cell(name)
    return SimpleNamespace(cell=cell, info={"infer": program.settings(cell)["infer"]},
                           model=cell.config["model"])


def _digest(rows):
    return hashlib.sha256(repr([dataclasses.astuple(r) for r in rows]).encode()).hexdigest()[:16]


def test_every_cell_is_pinned():
    assert sorted(PINNED) == sorted(w["name"] for w in registry.load().spec["workloads"])


@pytest.mark.parametrize("name", sorted(PINNED))
def test_a_cells_counted_figures_are_the_parents(name):
    flops, nbytes, whole, batch, halo, m, grid, frame_plane, digest = PINNED[name]
    bench = registry.load()
    run = _run(bench, name)
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
    assert _digest(rows + counts.count_network(run.model, *batch, arch)) == digest
    # a caller with the bare model dict finds the same module by the model's fields
    bare = counts.count_frame(run.model, run.info["infer"], h, w, halo)
    assert counts.totals(bare)["flops"] == flops


PLAIN = '''"""A plain stack of 5x5 convs without striding under a KPN head (plain
softmax), as Bako et al.'s kernel-predicting network."""

from h100_bench.reference.unet import _conv, conv_shapes, kpn_head, load_params, signal, to_device


def multiple(model):
    return 1


def halo(model):
    return 2 * (model["n_convs"] + 1) + model["kpn_size"] // 2


def _convs(model, cin, cout):
    widths = [cin] + [model["width"]] * model["n_convs"] + [cout]
    return {f"Plain_0/Conv_{i}": (5, a, b) for i, (a, b) in enumerate(zip(widths, widths[1:]))}


def network(p, x, model, f8=False):
    k2 = model["kpn_size"] ** 2
    y = x.permute(0, 3, 1, 2)
    convs = list(_convs(model, model["in_channels"], model["kpn_slots"] * k2))
    for i, name in enumerate(convs):
        y = _conv(p, name, y, act=i < len(convs) - 1, f8=f8)
    return kpn_head(p, y.permute(0, 2, 3, 1), signal(model, x), model)


def param_shapes(model):
    k2 = model["kpn_size"] ** 2
    return conv_shapes(_convs(model, model["in_channels"], model["kpn_slots"] * k2))
'''

COUNT = '''

def count_backbone(net, n, h, w, cin, cout, prefix=""):
    for i, (name, (k, a, b)) in enumerate(_convs(net.m, cin, cout).items()):
        net.conv_block(prefix + name, n, h, w, a, b, k, act=i < net.m["n_convs"])
'''


def _new_architecture(tmp_path, name, source):
    """A copy of the benchmark with reference/<name>.py, a configuration of
    that name (flagship-max's, its backbone the new one: group mode, a
    2-slot 5x5 KPN head) and its cell <name>.1080p on the 1080p traffic."""
    root = make_small(tmp_path)
    (root / "reference" / f"{name}.py").write_text(source)
    cfg = json.loads((BENCH / "configs" / "flagship-max.json").read_text())
    cfg["name"] = name
    cfg["model"].update(backbone=name, n_convs=3, width=32, kpn_logit_norm=False)
    cfg["bench"].update(reference=name, weights=str(tmp_path / "w.npz"))
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}.1080p"
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"check": {"frames": 2, "band_rows": 2048}, "limits": {"rel_l2": 0.01}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "a test", "reduced": [],
                            "file": f"h100_bench/configs/{name}.json",
                            "why": "a backbone the harness has not seen"})
    spec["workloads"].append({"name": cell, "config": name, "traffic": "frames-1080p", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("frames_per_s", "mfu.frame"):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, registry.load(tmp_path / "BENCHMARK.json", root)


def test_a_new_architecture_is_validated_counted_planned_and_seeded_from_its_module(tmp_path):
    root, bench = _new_architecture(tmp_path, "plain5x5", PLAIN + COUNT)
    assert registry.validate(bench) == []
    run = _run(bench, "plain5x5.1080p")
    arch = readers.arch(run)
    model = run.model
    h, w = readers.frame_hw(run)
    # the plane divides 1: the halo of 10 (2 for each of 4 convs, 2 for the
    # 5x5 filter) stays 10, where 2**depth would round it to 16
    assert (h, w) == (64, 96) and arch.halo(model) == 10
    assert readers.net_batch(run) == (4, 64 + 20, 96 + 20)
    assert dataclasses.astuple(readers.plan(run)) == (64, 96, 64, 96, 10, 1, 1)
    assert registry.driver("frames", root).plane(run.cell) == (10, 10, 1)
    # its own rows: 2 * N * H * W * Co * Ci * 25 FLOPs a conv
    rows = counts.count_frame(model, run.info["infer"], h, w, 10, arch=arch)
    convs = [r for r in rows if r.kind == "conv"]
    n, nh, nw = readers.net_batch(run)
    want = [(14, 32), (32, 32), (32, 32), (32, 50)]
    assert [r.name for r in convs] == [f"Plain_0/Conv_{i} conv5x5" for i in range(4)]
    assert [r.flops for r in convs] == [2 * n * nh * nw * co * ci * 25 for ci, co in want]
    assert readers.whole_frame_flops(run) == counts.totals(rows)["flops"]
    # seeded from its own shapes; the file loads into its own network
    assert seeded.main(["--config", "plain5x5", "--seed", "7", "--gain", "1.2",
                        "--bias-std", "0.01", "--out", str(tmp_path / "w.npz")], root=root) == 0
    with np.load(tmp_path / "w.npz") as z:
        got = {k: z[k].shape for k in z.files}
    assert got == {f"params/{k}": v for k, v in arch.param_shapes(model).items()}
    p = arch.to_device(arch.load_params(tmp_path / "w.npz"), torch.device("cpu"))
    assert arch.network(p, torch.rand(4, 12, 12, 14), model).shape == (4, 12, 12, 6)


def test_a_backbone_that_no_module_counts_raises(tmp_path):
    root, bench = _new_architecture(tmp_path, "nocount", PLAIN)
    assert any("nocount" in p and "count_backbone" in p for p in registry.validate(bench))
    run = _run(bench, "nocount.1080p")
    with pytest.raises(ValueError, match="count_backbone"):
        counts.count_frame(run.model, run.info["infer"], 64, 96, 8, arch=readers.arch(run))
    # without a module, the model's own fields name one that is not there
    with pytest.raises(ValueError, match="nocount"):
        counts.count_network(run.model, 1, 64, 96)


@pytest.mark.parametrize("preset,weights", [("tiramisu-lt1", "tiramisu_lt1_ema_f16.npz"),
                                            ("tiramisu", "tiramisu_ema_f16.npz"),
                                            ("tiramisu-fast", "tiramisu_fast_ema_f16.npz"),
                                            ("flagship-hq", "flagship_hq_ema_f16.npz")])
def test_param_shapes_are_the_release_files(preset, weights):
    from deepdenoiser_tpu_torch import config

    model = config.to_dict(config.validate_channels(config.PRESETS[preset]))["model"]
    arch = tiramisu if model["backbone"] == "tiramisu" else unet
    with np.load(REPO / "weights" / weights) as z:
        got = {k.split("/", 1)[1]: z[k].shape for k in z.files}
    assert arch.param_shapes(model) == got
