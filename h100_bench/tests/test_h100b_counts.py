"""The frozen counter (counts.py) and the reference's certified halo agree
with the program's at the commit they were copied from, and give the
figures PERF.md quotes."""

import json

import pytest

from h100_bench import counts
from h100_bench.reference import unet
from h100_bench.tests.conftest import BENCH


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_kpn_hq_1080p_frame_and_k1_launch_match_the_recorded_figures():
    c = _config("kpn-hq")
    t = counts.totals(counts.count_frame(c["model"], c["infer"], 1080, 1920, unet.halo(c["model"])))
    assert round(t["flops"] / 1e9, 1) == 4110.0
    assert round(t["bytes"] / 1e9, 2) == 42.07
    assert round(counts.count_kpn_apply(1, 1144, 1984).bytes / 1e6, 1) == 281.4
    assert round(counts.count_kpn_apply_bwd_weights(16, 96, 96).bytes / 1e6, 1) == 18.3
    assert round(counts.count_group_encode(4, 1080, 1920).bytes / 1e6, 1) == 804.6


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-max", "flagship-hq", "flagship",
                                    "tiramisu-lt1", "unet-multiscale"])
@pytest.mark.parametrize("tile,tile_batch,hw", [(0, 0, (1080, 1920)), (512, 8, (2160, 3840)),
                                                (256, 0, (200, 328))])
def test_frozen_count_frame_equals_the_programs(preset, tile, tile_batch, hw):
    import dataclasses

    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.models import factory
    from deepdenoiser_tpu_torch.tools import roofline

    exp = config.validate_channels(config.PRESETS[preset])
    if exp.data.mode == "rgb" or (exp.model.n_scales > 1 and tile):
        pytest.skip("not a frame the counter plans")
    icfg = dataclasses.replace(exp.infer, tile=tile, tile_batch=tile_batch)
    theirs = roofline.count_frame(exp.model, icfg, *hw)
    ours = counts.count_frame(config.to_dict(exp)["model"], dataclasses.asdict(icfg), *hw,
                              factory.halo(exp.model))
    assert [(r.name, r.flops, r.bytes, r.calls) for r in ours] == \
        [(r.name, r.flops, r.bytes, r.calls) for r in theirs]


@pytest.mark.parametrize("preset", ["kpn-hq", "flagship-max", "flagship-hq", "flagship", "kpn"])
def test_reference_halo_equals_the_programs(preset):
    from deepdenoiser_tpu_torch import config
    from deepdenoiser_tpu_torch.models import factory

    exp = config.validate_channels(config.PRESETS[preset])
    assert unet.halo(config.to_dict(exp)["model"]) == factory.halo(exp.model)


def test_bound_is_the_larger_of_compute_and_memory():
    row = counts.count_kpn_apply(1, 1144, 1984)
    assert counts.bound_s([row]) == pytest.approx(row.bytes / counts.PEAK_HBM_BPS)
    assert row.flops / counts.PEAK_FLOPS["float32"] < row.bytes / counts.PEAK_HBM_BPS
