"""The resize-convs' sub-pixel epilogue: its launches a frame, from the
program's plain count, None where the program has no such count (a program
that resizes, then convolves); the conv epilogue's roofline times its
sub-pixel instantiation with the in-place one, since both move the bytes of
counts.py's `bias` rows."""

import sys
import types

import pytest

from h100_bench.tests.test_h100b_metrics import KERNELS, _metric, _run

BIAS_ACT = "deepdenoiser_tpu_torch.ops.bias_act"
PLAIN = ("void (anonymous namespace)::bias_act_kernel<__nv_bfloat16, 2, false, false, 8>"
         "(const T1 *, const float *, T1 *, unsigned int, unsigned int, unsigned int, "
         "unsigned int, unsigned int)")
SUBPIXEL = PLAIN.replace("false, false, 8", "false, true, 8")


@pytest.mark.parametrize("cell,a_frame", [("kpn-hq.1080p", 3), ("kpn-hq.4k-tiled", 15),
                                          ("unet-multiscale.1080p", 9)])
def test_subpixel_launches_are_the_programs_count_over_every_frame(monkeypatch, cell, a_frame):
    run = _run(cell, attempted=3)
    frames = run.cell.traffic.get("warm", 0) + 3
    monkeypatch.setitem(sys.modules, BIAS_ACT, types.SimpleNamespace(
        launches=21 * frames, subpixel_launches=a_frame * frames))
    assert _metric("subpixel_launches.frame", run) == a_frame
    monkeypatch.setitem(sys.modules, BIAS_ACT, types.SimpleNamespace(launches=21 * frames))
    assert _metric("subpixel_launches.frame", run) is None


def test_the_epilogue_roofline_times_both_instantiations():
    def kernels(sub_ns):
        return KERNELS + [k for f in range(3) for k in (
            (PLAIN, f * 10_000_000 + 9_000_000, 200_000),
            (SUBPIXEL, f * 10_000_000 + 9_300_000, sub_ns))]

    one, both = (_metric("bias_act_roofline", _run("kpn-hq.1080p", kernels(n)))
                 for n in (0, 200_000))
    assert one == pytest.approx(2 * both)
