"""The port's headline benchmark (deepdenoiser_tpu_torch/tools/bench.py)
on the CPU against bench.py's quality-only record.

bench.py degrades to that record by itself on a wedged chip
(tests/test_bench_contract.py monkeypatches its probe the same way); the
port gives it only for an explicit --device cpu. The same models on the
same numpy families at 128x192: each family's gain within 0.05 dB. The
traced mc family is left out: the port's tracer draws from a
torch.Generator, not threefry, so its frames are other samples.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch.tools import bench as port_bench
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DB_TOL = 0.05
H, W = 128, 192
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "status", "headline", "note"}
FAMILIES = ("fourier", "holdout", "holdout2")


@pytest.fixture(scope="module")
def jax_record():
    import bench
    from deepdenoiser_tpu.utils import tpu_guard

    mp = pytest.MonkeyPatch()
    mp.setattr(tpu_guard, "probe_compute", lambda timeout_s=60.0: False)
    try:
        return bench.run(argparse.Namespace(
            border=32, model="flagship", speed_model="", mc_model="", mc_gt_spp=0,
            probe_timeout=5.0, wedged_height=H, wedged_width=W))
    finally:
        mp.undo()


def _port(capsys, *extra):
    capsys.readouterr()
    assert port_bench.main(["--device", "cpu", "--cpu-height", str(H), "--cpu-width", str(W),
                            "--mc-gt-spp", "0", *extra]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_cpu_record_matches_the_jax_degraded_record(jax_record, capsys):
    got = _port(capsys, "--model", "flagship", "--speed-model", "", "--mc-model", "")
    assert set(jax_record) == TOP_KEYS
    assert TOP_KEYS <= set(got) and {"device", "power_limit_w"} <= set(got)
    assert got["metric"] == jax_record["metric"] == "1080p_full_multipass_denoise_throughput"
    assert got["unit"] == jax_record["unit"]
    assert got["status"] == "cpu" and got["value"] is None and got["vs_baseline"] is None
    assert got["device"] == "cpu" and got["power_limit_w"] is None
    head, want = got["headline"], jax_record["headline"]
    assert set(head) == set(want)
    assert head["ms"] is None and head["fps"] is None
    assert (head["model"], head["weights"]) == (want["model"], want["weights"])
    for fam in FAMILIES:
        assert abs(head[f"db_{fam}"] - want[f"db_{fam}"]) <= DB_TOL, (fam, head, want)
        assert 0.0 < head[f"ssim_{fam}"] <= 1.0
    assert head["db_fourier"] > 1.0


def test_cpu_record_measures_each_endpoint_once(capsys):
    got = _port(capsys, "--model", "kpn-hq", "--speed-model", "kpn-hq",
                "--mc-model", "flagship")
    assert "speed" not in got
    assert got["headline"]["model"] == "kpn-hq" and got["mc"]["model"] == "flagship"
    for obj in (got["headline"], got["mc"]):
        assert obj["ms"] is None and set(obj) == {
            "model", "ms", "fps", "weights", *(f"{m}_{f}" for f in FAMILIES
                                               for m in ("db", "ssim"))}
        assert all(np.isfinite(obj[f"db_{f}"]) for f in FAMILIES)


def test_bench_refuses_non_joint_models(capsys):
    with pytest.raises(ValueError, match="joint-mode"):
        _port(capsys, "--model", "kpn", "--speed-model", "", "--mc-model", "")


def test_bench_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main([])
