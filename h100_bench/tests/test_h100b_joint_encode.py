"""The joint encode's two metrics: its launches a frame, from the program's
plain count, and its share of its roofline, from the trace; None where the
program has no such count or the trace no such kernel, as at a program
without the kernel."""

import sys
import types

import pytest

from h100_bench.tests.test_h100b_metrics import KERNELS, _metric, _run

JOINT = ("void (anonymous namespace)::joint_encode_kernel<true, true, true>"
         "((anonymous namespace)::JointArgs)")
FUSED_INGEST = "deepdenoiser_tpu_torch.ops.fused_ingest"


def _with_encode(ns_a_frame):
    return KERNELS + [(JOINT, f * 10_000_000 + 9_000_000, ns_a_frame) for f in range(3)]


@pytest.mark.parametrize("cell,frame_px,plane_px", [
    ("kpn-hq.1080p", 1080 * 1920, 1144 * 1984),
    ("tiramisu-lt1.1080p", 1080 * 1920, 1144 * 1984),
    ("kpn-hq.4k-tiled", 2160 * 3840, 2704 * 4240),  # 5 x 8 tiles of 512, halo 72
])
def test_joint_encode_roofline_counts_the_passes_read_and_the_plane_written(cell, frame_px,
                                                                            plane_px):
    run = _run(cell, _with_encode(250_000))
    bytes_ = frame_px * 41 * 4 + plane_px * 41 * 4
    assert _metric("joint_encode_roofline", run) == pytest.approx(100 * bytes_ / 3.35e12 / 250e-6)
    assert _metric("joint_encode_roofline", _run(cell, KERNELS)) is None
    assert _metric("joint_encode_roofline", _run("flagship-max.1080p", _with_encode(1))) is None


def test_joint_encode_launches_are_the_programs_count_over_every_frame(monkeypatch):
    run = _run("kpn-hq.1080p", attempted=3)
    frames = run.cell.traffic.get("warm", 0) + 3
    monkeypatch.setitem(sys.modules, FUSED_INGEST, types.SimpleNamespace(
        joint_encode_launches=frames, launches={"group_encode": 0}))
    assert _metric("joint_encode_launches.frame", run) == 1.0
    monkeypatch.setitem(sys.modules, FUSED_INGEST, types.SimpleNamespace(
        launches={"group_encode": 0}))
    assert _metric("joint_encode_launches.frame", run) is None
