"""BENCHMARK.json keeps to the benchmark's contract, and the harness is
driven by data: a new cell, configuration, traffic mix and metric, written
as new files in a copy of the folder, are found by name, validated and run,
and no file that was there changes."""

import hashlib
import json
import re

import torch

from h100_bench import harness, registry
from h100_bench.tests.conftest import BENCH, REPO, make_small

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_the_benchmark_validates():
    assert registry.validate(registry.load(REPO / "BENCHMARK.json", BENCH)) == []


def test_keys_names_units_and_texts_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(TEXT.match(w) for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(SPEC["paths"][0] + "/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_layer_is_named_alike_by_all_its_metrics():
    by = {}
    for m in SPEC["per_layer"]:
        by.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values())


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = make_small(tmp_path)
    before = _digest(root)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a configuration: kpn-hq at base width 48, in a file of its own
    cfg = json.loads((root / "configs" / "kpn-hq.json").read_text())
    cfg["model"]["base_width"] = 48
    (root / "configs" / "kpn-hq-48.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "kpn-hq-48", "source": "a test", "file": "h100_bench/configs/kpn-hq-48.json",
                            "reduced": [], "why": "a test"})
    # a traffic mix: smaller frames, one more warm-up
    t = json.loads((root / "traffic" / "frames-1080p.json").read_text())
    (root / "traffic" / "frames-tiny.json").write_text(json.dumps({**t, "height": 32, "width": 48, "pool": 2}))
    (root / "workloads" / "kpn-hq-48.tiny.json").write_text(json.dumps(
        {"check": {"frames": 1, "band_rows": 64}, "limits": {"rel_l2": 1e-2}}))
    spec["workloads"].append({"name": "kpn-hq-48.tiny", "config": "kpn-hq-48", "traffic": "frames-tiny",
                              "chips": 1, "why": "a test"})
    # a metric: the frames the window completed
    (root / "metrics" / "frames_done.py").write_text(
        'UNIT, BETTER, SOURCE = "frames", "higher", "host_clock"\n'
        'LAYER, MOVES = "whole frame (inference/pipeline)", "frames_per_s"\n'
        "def read(run):\n    return run.attempted\n")
    spec["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "whole frame (inference/pipeline)",
                              "moves": "frames_per_s", "workloads": ["kpn-hq-48.tiny"]})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("kpn-hq-48.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = registry.load(tmp_path / "BENCHMARK.json", root)
    assert registry.validate(bench) == []
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = bench.cell("kpn-hq-48.tiny")
    assert cell.config["model"]["base_width"] == 48 and cell.traffic["height"] == 32
    assert [m["name"] for m in cell.per_layer] == ["frames_done"]
    # the new configuration's weights are seeded random ones of its own shapes
    from deepdenoiser_tpu_torch import config, weights_io
    from deepdenoiser_tpu_torch.models import factory

    exp = config.from_dict(config.ExperimentConfig, {k: v for k, v in cfg.items() if k != "bench"})
    model = factory.init_model(exp.model, torch.Generator().manual_seed(0))
    weights_io.save_release_params(tmp_path / "w48.npz", weights_io.params_from_state_dict(model.state_dict()))
    cfg["bench"]["weights"] = str(tmp_path / "w48.npz")
    (root / "configs" / "kpn-hq-48.json").write_text(json.dumps(cfg))
    bench = registry.load(tmp_path / "BENCHMARK.json", root)
    r = harness.run_cell(bench, "kpn-hq-48.tiny", 3, 0.2, True, torch.device("cpu"), 0.0)
    assert r["metrics"]["frames_done"]["value"] == r["attempted"] >= 1
    assert list(r)[-1] == "checks" and "rel_l2" in r["checks"]


def test_a_missing_file_or_a_mislabelled_metric_is_reported(tmp_path):
    root = make_small(tmp_path)
    (root / "metrics" / "k1_roofline.py").write_text(
        (root / "metrics" / "k1_roofline.py").read_text().replace('"%"', '"percent"'))
    (root / "traffic" / "frames-4k.json").unlink()
    ref = root / "reference" / "tiramisu.py"
    ref.write_text(ref.read_text().replace("def param_shapes(", "def _param_shapes("))
    problems = registry.validate(registry.load(tmp_path / "BENCHMARK.json", root))
    assert any("k1_roofline" in p and "unit" in p for p in problems)
    assert any("frames-4k" in p for p in problems)
    assert any("tiramisu-lt1" in p and "lacks param_shapes" in p for p in problems)
