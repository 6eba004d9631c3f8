"""Nothing a run loads is JAX or the JAX package, and the references load
nothing of the program. Each check runs in a fresh interpreter and reads
sys.modules by top-level name (the part before the first dot), compared
whole: the program's name, deepdenoiser_tpu_torch, begins with the JAX
package's."""

import json
import subprocess
import sys

from h100_bench import run
from h100_bench.tests.conftest import REPO

JAX_SIDE = {"jax", "jaxlib", "flax", "deepdenoiser_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import torch
from pathlib import Path
from h100_bench import harness, registry, run, calibrate
from h100_bench.tests.conftest import TRAIN, make_small
root = make_small(Path({str(tmp_path)!r}))
bench = registry.load(root.parent / "BENCHMARK.json", root)
for name in ("kpn-hq.1080p", "flagship-max.1080p", TRAIN):
    r = harness.run_cell(bench, name, 3, 0.1, True, torch.device("cpu"), 0.0)
    assert r["checks"], r
    for m in bench.cell(name).end_to_end + bench.cell(name).per_layer:
        registry.metric(m["name"], root)
assert not run.forbidden_modules()
"""
    mods = _modules(code)
    assert "deepdenoiser_tpu_torch" in mods and "torch" in mods
    assert not mods & JAX_SIDE


def test_the_references_load_nothing_of_the_program():
    code = """
import numpy as np, torch
from h100_bench import counts, traffic
from h100_bench.reference import frame, train, unet
import json
c = json.load(open("h100_bench/configs/kpn-hq.json"))
p = unet.to_device(unet.load_params(c["bench"]["weights"]), torch.device("cpu"))
f = traffic.frames({"pool": 1, "height": 16, "width": 24, "spp": 4}, 1, torch.device("cpu"))[0]
out = frame.denoise(lambda x: unet.network(p, x, c["model"]), f, "joint", 32, 72, 8, 10000)
counts.count_frame(c["model"], c["infer"], 16, 24, unet.halo(c["model"]))
"""
    mods = _modules(code)
    assert "torch" in mods
    assert not mods & (JAX_SIDE | {"deepdenoiser_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"deepdenoiser_tpu_torch": 1, "deepdenoiser_tpu_torch.models": 1, "jaxtyping": 1,
            "flaxen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "jax.numpy": 1, "deepdenoiser_tpu.ops": 1})
    assert run.forbidden_modules() == ["deepdenoiser_tpu", "jax"]
