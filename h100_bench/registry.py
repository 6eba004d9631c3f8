"""What the benchmark is made of, found by name.

BENCHMARK.json (at the root of the checkout) names the configurations, the
cells and the metrics; each lives in files of its own under this folder:

  configs/<config>.json    the configuration as it is run: the program's
                           experiment config (model, data, train, infer)
                           and a "bench" group: release weights file and the
                           reference module (reference/<module>.py)
  reference/<module>.py    the architecture's plain reference, and the one
                           place that describes it to the harness:
                           load_params, to_device, network (the forward),
                           halo (certified receptive field), multiple (what
                           the plane divides), count_backbone (its rows of
                           counts.py) and param_shapes (what a seeded
                           weights file holds); a configuration names it
  traffic/<traffic>.json   a traffic mix: the driver that runs it
                           (drivers/<driver>.py) and the generator's
                           parameters (traffic.py)
  workloads/<cell>.json    the cell's settings: "infer" / "train" overrides
                           of the program's config, what the check compares
                           ("check") and the limits of `correct` ("limits")
  metrics/<metric>.py      one metric: UNIT, BETTER, SOURCE, for a per-layer
                           metric LAYER and MOVES, and read(run) -> number
                           or None

A later change adds a cell, a configuration, a traffic mix or a metric by
adding such files and entries to BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# what every module under reference/ that a configuration names defines
ARCHITECTURE = ("load_params", "to_device", "network", "halo", "multiple", "count_backbone",
                "param_shapes")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


@dataclasses.dataclass
class Bench:
    spec: dict
    root: Path  # the benchmark's folder

    @property
    def repo(self) -> Path:
        return self.root.parent

    def cell(self, name: str) -> Cell:
        by = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by:
            raise KeyError(f"no workload {name!r}; known: {sorted(by)}")
        w = by[name]
        cfg = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        e2e = [m for m in self.spec["end_to_end"] if reports(m, w["name"], None)]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"] if reports(m, w["name"], moved)]
        return Cell(
            name=name, chips=w["chips"],
            config=_json(self.repo / cfg["file"]),
            traffic=_json(self.root / "traffic" / f"{w['traffic']}.json"),
            workload=_json(self.root / "workloads" / f"{name}.json"),
            end_to_end=e2e, per_layer=per_layer, root=self.root)


def reports(metric: dict, cell: str, moved: Optional[set]) -> bool:
    """Whether `cell` reports `metric`: listed under its "workloads", or
    with no such key, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moved is None or metric["moves"] in moved


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load(path: Optional[Path] = None, root: Path = HERE) -> Bench:
    path = path or root.parent / "BENCHMARK.json"
    return Bench(spec=_json(path), root=root)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = HERE) -> ModuleType:
    return _module(root / "metrics" / f"{name}.py", f"h100_bench_metric_{name}")


def driver(name: str, root: Path = HERE) -> ModuleType:
    return _module(root / "drivers" / f"{name}.py", f"h100_bench_driver_{name}")


def reference(name: str, root: Path = HERE) -> ModuleType:
    return _module(root / "reference" / f"{name}.py", f"h100_bench_reference_{name}")


def architecture(model: dict, root: Path = HERE) -> ModuleType:
    """The reference module a bare model dict names by its own fields, for a
    caller that has the model and no configuration: reference/multiscale.py
    under scales, reference/<backbone>.py otherwise. A cell's own module is
    the one its configuration names (bench.reference)."""
    name = "multiscale" if model["n_scales"] > 1 else model["backbone"]
    if not (root / "reference" / f"{name}.py").is_file():
        raise ValueError(f"no reference module describes backbone {model['backbone']!r}: "
                         f"no reference/{name}.py")
    return reference(name, root)


def validate(bench: Bench) -> List[str]:
    """Every problem with BENCHMARK.json and the files it names; [] when
    none. Checks names and units, that every file exists, that each
    configuration's reference module defines every function of
    ARCHITECTURE, that each metric file declares what BENCHMARK.json says
    of it, and that every cell
    reports setup_s, another end-to-end metric and a per-layer metric."""
    spec, root, repo = bench.spec, bench.root, bench.repo
    problems: List[str] = []

    def name_ok(what, n):
        if not isinstance(n, str) or not NAME.match(n):
            problems.append(f"{what} {n!r} is not a valid name")

    for c in spec["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
        if not (repo / c["file"]).is_file():
            problems.append(f"config {c['name']}: no file {c['file']}")
        else:
            b = _json(repo / c["file"]).get("bench", {})
            for key in ("weights", "reference"):
                if key not in b:
                    problems.append(f"config {c['name']}: no bench.{key}")
            if "reference" in b and not (root / "reference" / f"{b['reference']}.py").is_file():
                problems.append(f"config {c['name']}: no reference/{b['reference']}.py")
            elif "reference" in b:
                mod = reference(b["reference"], root)
                lacks = [f for f in ARCHITECTURE if not callable(getattr(mod, f, None))]
                if lacks:
                    problems.append(f"config {c['name']}: reference/{b['reference']}.py lacks "
                                    + ", ".join(lacks))
    metrics = spec["end_to_end"] + spec["per_layer"]
    for m in metrics:
        name_ok("metric", m["name"])
        if not UNIT.match(m["unit"]):
            problems.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["source"] not in SOURCES:
            problems.append(f"metric {m['name']}: source {m['source']!r}")
        path = root / "metrics" / f"{m['name']}.py"
        if not path.is_file():
            problems.append(f"metric {m['name']}: no {path.name}")
            continue
        mod = metric(m["name"], root)
        for key in ("unit", "better", "source") + (("layer", "moves") if m in spec["per_layer"] else ()):
            if getattr(mod, key.upper(), None) != m[key]:
                problems.append(f"metric {m['name']}: {key} {m[key]!r} in BENCHMARK.json, "
                                f"{getattr(mod, key.upper(), None)!r} in its file")
    cells = {w["name"] for w in spec["workloads"]}
    for m in metrics:
        for c in sorted(set(m.get("workloads", ())) - cells):
            problems.append(f"metric {m['name']}: no workload {c}")
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        if w["config"] not in configs:
            problems.append(f"workload {w['name']}: no config {w['config']}")
        tpath = root / "traffic" / f"{w['traffic']}.json"
        if not tpath.is_file():
            problems.append(f"workload {w['name']}: no traffic/{tpath.name}")
        elif not (root / "drivers" / f"{_json(tpath)['driver']}.py").is_file():
            problems.append(f"traffic {w['traffic']}: no driver {_json(tpath)['driver']}")
        if not (root / "workloads" / f"{w['name']}.json").is_file():
            problems.append(f"workload {w['name']}: no workloads/{w['name']}.json")
        cell_e2e = [m["name"] for m in spec["end_to_end"] if reports(m, w["name"], None)]
        cell_pl = [m for m in spec["per_layer"] if reports(m, w["name"], set(cell_e2e))]
        if "setup_s" not in cell_e2e or len(cell_e2e) < 2 or not cell_pl:
            problems.append(f"workload {w['name']}: needs setup_s, another end-to-end "
                            "metric and a per-layer metric")
        for m in cell_pl:
            if m["moves"] not in cell_e2e:
                problems.append(f"workload {w['name']}: {m['name']} moves {m['moves']}, "
                                "which the cell does not report")
    return problems
