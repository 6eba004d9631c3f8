"""On the card (the `gpu` marker; skipped without one): a cell's run
command end to end, and the control at the cell's own size failing the
limit that sound runs keep.

    python -m pytest h100_bench/tests -m gpu -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest
import torch

from h100_bench.tests.conftest import REPO

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_a_short_run_of_a_cell_is_correct(card):
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "kpn-hq.1080p",
                          "--seed", "2147483999", "--seconds", "2", "--trace", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "k1_roofline" in r["metrics"] and out.stderr.strip().splitlines()[-1] == "correct = True"


def test_the_control_fails_where_the_program_holds(card):
    from h100_bench import calibrate, registry

    cell = registry.load().cell("kpn-hq.1080p")
    r = calibrate.readings(cell, 17, 1.0, True, card)
    limit = cell.workload["limits"]["rel_l2"]
    assert r["program"]["rel_l2"] < limit < r["control_f8"]["rel_l2"]
