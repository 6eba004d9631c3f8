"""A small copy of the benchmark for tests on the CPU: the same files, with
the traffic cut to frames of 64 x 96 (72 x 104 for the tiled cell, tiles of
32 in chunks of 2) and training batches of 4 crops of 48, so a whole run
takes seconds. The release weights are linked, not copied.

BENCHMARK.json has no train cell yet: the recipe's step at batch 16 is not
steady enough on the card's host for a bound. The copy adds it
(`kpn-hq.train-b16`, with its metrics and the limits read on the card at
batch 128), so that the train driver, its reference and its metrics are
held here as a later cell will use them."""

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent

SMALL_TRAFFIC = {
    "frames-1080p": {"height": 64, "width": 96, "warm": 1},
    "frames-4k": {"height": 72, "width": 104, "warm": 1},
    "train-recipe-b16": {"batch": 4, "crop": 48, "pool": 4},
}
TRAIN = "kpn-hq.train-b16"
TRAIN_LIMITS = {"loss_gap": 0.0035, "step_gap": 0.1, "grad_rel_l2": 0.035}
TRAIN_METRICS = ("mfu.train", "device_idle_pct.train", "k1_bwd_roofline")
SMALL_WORKLOAD = {
    "kpn-hq.4k-tiled": {"infer": {"tile": 32, "tile_batch": 2}, "check": {"band_rows": 48}},
}


def make_small(dest: Path) -> Path:
    """Copy the benchmark folder and BENCHMARK.json under `dest`, cut the
    traffic to test sizes, link the weights; returns the copy's folder."""
    root = dest / "h100_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _with_train_cell(root, dest / "BENCHMARK.json")
    (dest / "weights").symlink_to(REPO / "weights")
    for name, over in SMALL_TRAFFIC.items():
        p = root / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **over}))
    for name, over in SMALL_WORKLOAD.items():
        p = root / "workloads" / f"{name}.json"
        d = json.loads(p.read_text())
        for k, v in over.items():
            d[k] = {**d.get(k, {}), **v}
        p.write_text(json.dumps(d))
    return root


def _with_train_cell(root: Path, dest: Path) -> None:
    from h100_bench import registry

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TRAIN, "config": "kpn-hq", "traffic": "train-recipe-b16",
                              "chips": 1, "why": "the recipe's train step"})
    spec["end_to_end"].append({"name": "train_samples_per_s", "unit": "samples/s",
                               "better": "higher", "bound": 0.25, "source": "host_clock",
                               "workloads": [TRAIN]})
    for name in TRAIN_METRICS:
        m = registry.metric(name, root)
        spec["per_layer"].append({"name": name, "unit": m.UNIT, "better": m.BETTER,
                                  "source": m.SOURCE, "layer": m.LAYER, "moves": m.MOVES,
                                  "workloads": [TRAIN]})
    dest.write_text(json.dumps(spec))
    (root / "workloads" / f"{TRAIN}.json").write_text(json.dumps({"limits": TRAIN_LIMITS}))


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    torch.set_num_threads(4)
    return make_small(tmp_path_factory.mktemp("small"))


@pytest.fixture(scope="session")
def small_bench(small_root):
    from h100_bench import registry

    return registry.load(small_root.parent / "BENCHMARK.json", small_root)
