"""The port's span recorder (deepdenoiser_tpu_torch/tracing.py) and the
tiled apply's network-call counter, on the CPU: nothing is recorded while
the recorder is off; with it on, each frame mode records the span tree the
benchmark reads, one frame id a call; the outputs are bit-identical either
way; `tiled.net_calls` counts the network calls.

The models are the presets' architectures at base width 8 and depth 2,
seeded random weights, fp32, on 64 x 96 frames.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config, tracing, weights_io
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models import factory

H, W = 64, 96
# (preset, infer overrides): the frame paths of the benchmark's cells and
# the plain group encode
MODES = {
    "joint": ("kpn-hq", {}),
    "joint-lazy-tiled": ("kpn-hq", {"tile": 32, "tile_batch": 2}),
    "group-fused": ("flagship-max", {"use_pallas_ingest": True}),
    "group-stacked": ("flagship-max", {"use_pallas_ingest": False}),
    "rgb": ("kpn-hq", {}),
}


@functools.lru_cache(maxsize=None)
def _frame():
    clean = synthetic.generate_clean_passes(H, W, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=6)
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in noisy.items()}


@functools.lru_cache(maxsize=None)
def _denoiser(mode):
    preset, over = MODES[mode]
    cfg = config.validate_channels(config.PRESETS[preset])
    model_cfg = dataclasses.replace(cfg.model, base_width=8, depth=2, compute_dtype="float32")
    if mode == "rgb":
        model_cfg = dataclasses.replace(model_cfg, in_channels=10, out_channels=3, kpn_slots=1)
    infer = dataclasses.replace(cfg.infer, compute_dtype="float32", **over)
    model = factory.init_model(model_cfg, torch.Generator().manual_seed(0))
    params = weights_io.params_from_state_dict(model.state_dict())
    make = {"joint": pipeline.make_joint_frame_denoiser, "group": pipeline.make_group_frame_denoiser,
            "rgb": pipeline.make_rgb_frame_denoiser}[mode.split("-")[0]]
    return make(model_cfg, infer, H, W, params, device="cpu")


@pytest.fixture
def recording():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


def _tree(spans):
    """The spans as nested (name, children) tuples, children by start."""
    kids = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return (s.name, tuple(node(c) for c in kids.get(s.id, ())))

    return tuple(node(s) for s in kids.get(None, ()))


def _model(slots):
    return ("chunk", (("backbone", ()), ("head", (("k1", ()),) * slots)))


def _expected(mode, chunks=1):
    slots = {"joint": 8, "group": 2, "rgb": 1}[mode.split("-")[0]]
    net = ("net", (_model(slots),) * chunks)
    return (("frame", (("encode", ()), net, ("decode", ()))),)


def test_off_records_nothing_and_span_is_one_shared_no_op():
    tracing.disable()
    assert tracing.span("frame") is tracing.span("k1")
    _denoiser("joint")[0](_frame())
    assert tracing.take() == []


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_mode_records_its_span_tree_with_one_frame_id_a_call(mode, recording):
    den, grid = _denoiser(mode)
    chunks = -(-grid.n_tiles // 2) if mode == "joint-lazy-tiled" else 1
    for _ in range(2):
        den(_frame())
    spans = tracing.take()
    assert tracing.take() == []
    frames = sorted({s.frame for s in spans})
    assert frames == [0, 1]
    for f in frames:
        mine = [s for s in spans if s.frame == f]
        assert _tree(mine) == _expected(mode, chunks)
        root = next(s for s in mine if s.parent is None)
        by_id = {s.id: s for s in mine}
        for s in mine:
            if s.parent is not None:
                up = by_id[s.parent]
                assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert root.name == "frame"
    assert len({s.id for s in spans}) == len(spans)


@pytest.mark.parametrize("mode", ["joint", "joint-lazy-tiled", "group-fused"])
def test_outputs_are_bit_identical_with_the_recorder_on_and_off(mode):
    den, _ = _denoiser(mode)
    tracing.disable()
    off = den(_frame())
    tracing.enable()
    try:
        on = den(_frame())
    finally:
        tracing.disable()
        tracing.take()
    assert off.keys() == on.keys()
    assert all(torch.equal(off[k], on[k]) for k in off)


def test_net_calls_counts_each_chunk_or_plane_and_reset_zeroes_it():
    den, grid = _denoiser("joint-lazy-tiled")
    assert grid.n_tiles == 6
    tiled.reset_net_calls()
    den(_frame())
    assert tiled.net_calls == 3
    den(_frame())
    assert tiled.net_calls == 6
    tiled.reset_net_calls()
    assert tiled.net_calls == 0
    _denoiser("joint")[0](_frame())
    _denoiser("group-fused")[0](_frame())
    assert tiled.net_calls == 2
    tiled.reset_net_calls()


def test_enable_numbers_spans_and_frames_from_zero_and_take_clears(recording):
    with tracing.span("frame"):
        with tracing.span("encode"):
            pass
    with tracing.span("frame"):
        pass
    tracing.enable()
    with tracing.span("frame"):
        pass
    spans = tracing.take()
    assert [(s.name, s.id, s.parent, s.frame) for s in spans] == [("frame", 0, None, 0)]
    with tracing.span("frame"):
        with tracing.span("encode"):
            pass
    assert [(s.name, s.id, s.parent, s.frame) for s in tracing.take()] == [
        ("encode", 2, 1, 1), ("frame", 1, None, 1)]
