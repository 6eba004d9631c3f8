"""The port on the card, the one place it is checked there: every CUDA kernel
against its plain PyTorch version; every entry point a user calls (the frame
factories of each mode and preset, `deepdenoiser-torch` and its commands,
training, the tracer, the release tooling and the tools), each kernel's
launches counted on every path, bf16 frames held to fp32. Kernel times are
the benchmark's (h100_bench/), not these tests'.

Every test here carries the `gpu` marker and skips without a CUDA card
before doing any work. The file imports torch and the port only, so it runs
where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
"""

import contextlib
import dataclasses
import functools
import itertools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu_torch import config, passes, transforms, weights_io
from deepdenoiser_tpu_torch.data import exr, mc_tracer, synthetic, synthetic_device
from deepdenoiser_tpu_torch.data.draws import seeded
from deepdenoiser_tpu_torch.inference import pipeline, tiled
from deepdenoiser_tpu_torch.models import factory, kpn, layers, multiscale
from deepdenoiser_tpu_torch.ops import bias_act, fused_ingest, kpn_apply, kpn_softmax, metrics

import torch_flips  # noqa: E402  (tests/, on the path of every test module)

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest tests/test_torch_gpu.py -m gpu)")


@pytest.fixture
def cuda():
    _need_card()
    return torch.device("cuda")


@contextlib.contextmanager
def _full_fp32():
    """Full-precision fp32 convs and matmuls (TF32 off) inside the block."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _within(got, want):
    # the same fp32 taps in the same order; FMA contraction accounts for the slack
    return bool(torch.all((got - want).abs() <= 1e-5 + 1e-5 * want.abs()))


def _inputs(shape, k, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, h, w, _ = shape
    noisy = torch.rand(shape, generator=g, device=dev)
    weights = torch.softmax(torch.randn((n, h, w, k * k), generator=g, device=dev), -1)
    return noisy, weights


@pytest.mark.parametrize(
    "shape,k", [((1, 37, 53, 3), 5), ((2, 20, 36, 3), 3), ((1, 64, 96, 3), 5), ((1, 9, 7, 1), 3)]
)
def test_kpn_kernel_matches_plain_version(cuda, shape, k):
    noisy, weights = _inputs(shape, k, cuda)
    kpn_apply.reset_launches()
    got = kpn_apply.apply_per_pixel_kernels(noisy, weights, k)
    assert kpn_apply.launches == 1
    want = kpn.apply_per_pixel_kernels(noisy, weights, k)
    torch.cuda.synchronize()
    assert _within(got, want)


def test_kpn_kernel_still_takes_planar_weight_views(cuda):
    """A 3-channel slice of the 24-channel signal stack and a permuted view
    of planar (N, k², H, W) softmax weights: the kernel reads the weights
    through their strides, element by element."""
    k = 5
    g = torch.Generator(device=cuda).manual_seed(1)
    noisy = torch.rand((1, 40, 72, 24), generator=g, device=cuda)[..., 9:12]
    weights = torch.softmax(torch.randn((1, k * k, 40, 72), generator=g, device=cuda), 1)
    weights = weights.permute(0, 2, 3, 1)
    got = kpn_apply.apply_per_pixel_kernels(noisy, weights, k)
    want = kpn.apply_per_pixel_kernels(noisy.contiguous(), weights.contiguous(), k)
    torch.cuda.synchronize()
    assert _within(got, want)


def _head_layout_matches(noisy, weights, k):
    """One launch against the plain version, and a second one bitwise equal
    to the first."""
    kpn_apply.reset_launches()
    got = [kpn_apply.apply_per_pixel_kernels(noisy, weights, k) for _ in range(2)]
    assert kpn_apply.launches == 2
    want = kpn.apply_per_pixel_kernels(noisy, weights, k)
    torch.cuda.synchronize()
    assert got[0].shape == want.shape and got[0].is_contiguous()
    assert _within(got[0], want)
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("k", [3, 5])
def test_kpn_kernel_at_the_heads_layout(cuda, k, c):
    """The weights as the KPN head hands them: a contiguous (N,H,W,k²)
    softmax, the taps last."""
    noisy, weights = _inputs((2, 37, 60, c), k, cuda, seed=10 * k + c)
    assert weights.is_contiguous()
    _head_layout_matches(noisy, weights, k)


@pytest.mark.parametrize("stack,slot", [(24, 0), (24, 1), (24, 2), (24, 5), (24, 7), (14, 0),
                                        (14, 1), (8, 1)], ids=str)
def test_kpn_kernel_reads_slot_views_of_the_signal(cuda, stack, slot):
    """Slot s is channels 3s..3s+2 of the joint model's 24-channel signal,
    of group mode's 14-channel input, or of an 8-channel stack (the kpn
    TF golden's): 12 B at a 96, 56 or 32 B pixel stride."""
    k = 5
    g = torch.Generator(device=cuda).manual_seed(100 + stack + slot)
    noisy = torch.rand((2, 30, 64, stack), generator=g, device=cuda)[..., 3 * slot : 3 * slot + 3]
    weights = torch.softmax(torch.randn((2, 30, 64, k * k), generator=g, device=cuda), -1)
    _head_layout_matches(noisy, weights, k)


@pytest.mark.parametrize("shape,k,offset", [
    ((1, 17, 37, 3), 5, 0),   # W*k² = 925: weight rows start at every 16 B misalignment
    ((2, 9, 6, 3), 5, 0),     # W under one tile, W*k² not a multiple of 4
    ((3, 19, 21, 1), 3, 0),   # k = 3, W*k² = 189
    ((1, 1, 45, 3), 5, 0),    # one row
    ((4, 1, 1, 3), 3, 0),     # one pixel a frame
    ((2, 23, 9, 4), 5, 0),    # C = 4, ragged
    ((1, 13, 40, 3), 5, 1),   # weights 4 B past a 16 B boundary: every row shifted
    ((1, 13, 40, 2), 3, 3),   # C = 2, weights 12 B past
], ids=str)
def test_kpn_kernel_on_ragged_one_row_and_misaligned_frames(cuda, shape, k, offset):
    noisy, weights = _inputs(shape, k, cuda, seed=sum(shape) + k)
    if offset:  # the same values `offset` floats into a buffer: a contiguous, misaligned view
        buf = torch.empty(weights.numel() + offset, device=cuda)
        buf[offset:] = weights.flatten()
        weights = buf[offset:].view(weights.shape)
        assert weights.is_contiguous() and weights.data_ptr() % 16 == 4 * offset
    _head_layout_matches(noisy, weights, k)


@pytest.mark.parametrize("shape,rows", [((16, 96, 96, 3), 4), ((1, 64, 96, 3), 4),
                                        ((2, 600, 800, 3), 8)], ids=str)
def test_kpn_kernel_takes_both_tile_heights(cuda, shape, rows):
    """A launch whose 32x8 tiles fit in one wave of the card (the training
    batch) takes 32x4 tiles, a pixel a thread; a larger one 32x8 tiles,
    two pixels a thread. Both agree with the plain version."""
    assert kpn_apply.tile_rows(shape, 5) == rows
    g = torch.Generator(device=cuda).manual_seed(rows)
    noisy = torch.rand((*shape[:3], 24), generator=g, device=cuda)[..., 3:6]
    weights = torch.softmax(torch.randn((*shape[:3], 25), generator=g, device=cuda), -1)
    _head_layout_matches(noisy, weights, 5)


@pytest.mark.parametrize("lead,stack", [((1, 1144, 1984), 24), ((4, 1144, 1984), 14),
                                        ((8, 656, 656), 24)],
                         ids=["kpn-hq-1080p", "flagship-max-1080p", "kpn-hq-4k-tiles"])
def test_kpn_kernel_at_the_frame_cells_shapes(cuda, lead, stack):
    """Slot 1 of each frame cell's signal at its network call's batch: the
    joint 1080p plane, the group frame's four groups, a chunk of eight 4K
    tiles."""
    g = torch.Generator(device=cuda).manual_seed(11)
    noisy = torch.rand((*lead, stack), generator=g, device=cuda)[..., 3:6]
    weights = torch.softmax(torch.randn((*lead, 25), generator=g, device=cuda), -1)
    _head_layout_matches(noisy, weights, 5)


def test_kpn_kernel_fills_the_card_at_the_training_batch(cuda):
    """At (16,96,96,3), k=5, the forward's 1152 blocks of 32x4 pixels are
    all resident at once: no partial second wave."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kpn_apply.tile_rows((16, 96, 96, 3), 5) == 4
    assert kpn_apply.resident_blocks("forward", 5, 3, 4) * sms >= 16 * (96 // 4) * (96 // 32)


def test_kpn_kernel_refuses_other_dtypes(cuda):
    noisy, weights = _inputs((1, 8, 8, 3), 3, cuda)
    with pytest.raises(TypeError):
        kpn_apply.apply_per_pixel_kernels(noisy.half(), weights, 3)


def test_kpn_hq_frame_on_the_card_matches_the_cpu_port(cuda):
    """The joint kpn-hq frame at fp32 (TF32 off) launches the kernel once per
    slot and agrees with the same port on the CPU (held to the JAX package
    by tests/test_torch_pipeline.py)."""
    h, w = 64, 96
    clean = synthetic.generate_clean_passes(h, w, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=6)
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    icfg = dataclasses.replace(cfg.infer, compute_dtype="float32")
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    frame = {k: torch.from_numpy(v) for k, v in noisy.items()}
    with _full_fp32():
        den_gpu, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        got = den_gpu(frame)["combined"]
        torch.cuda.synchronize()
        assert kpn_apply.launches == cfg.model.kpn_slots
    den_cpu, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params, device="cpu")
    want = den_cpu(frame)["combined"].numpy()
    err = np.abs(got.cpu().numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


# --------------------------------------------------------------------------
# the fused-ingest kernels
# --------------------------------------------------------------------------

INGEST_SHAPES = [(37, 53), (2, 20, 36), (64, 96), (1, 1), (1080, 1920)]


def _ingest_within(got, want):
    # the same fp32 operations; log1pf may differ from PyTorch's in the last bit
    return bool(torch.all((got - want).abs() <= 1e-6 + 1e-6 * want.abs()))


def _raw_passes(lead, dev, seed=0):
    """Raw passes that reach every clamp: negative radiance, albedo 0,
    normals beyond [-1, 1], alpha outside [0, 1], negative depth."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(c, lo, hi):
        return lo + (hi - lo) * torch.rand((*lead, c), generator=g, device=dev)

    color = rand(3, -0.2, 1.0).clamp_min(0.0)  # a fifth of the albedo is exactly 0
    pd = {"normal": rand(3, -1.5, 1.5), "depth": rand(1, -2.0, 30.0), "alpha": rand(1, -0.5, 1.5)}
    for grp in ("diffuse", "glossy"):
        pd[f"{grp}_direct"] = rand(3, -1.0, 20.0)
        pd[f"{grp}_indirect"] = rand(3, -1.0, 5.0)
        pd[f"{grp}_color"] = color
    return pd


@pytest.mark.parametrize("lead", INGEST_SHAPES, ids=str)
@pytest.mark.parametrize("name", ["radiance", "normal", "depth_alpha", "depth", "alpha"])
def test_ingest_kernel_matches_plain_version(cuda, name, lead):
    pd = _raw_passes(lead, cuda)
    inputs = {
        "radiance": (pd["diffuse_direct"], pd["diffuse_indirect"], pd["diffuse_color"]),
        "normal": (pd["normal"],), "depth_alpha": (pd["depth"], pd["alpha"]),
        "depth": (pd["depth"],), "alpha": (pd["alpha"],),
    }[name]
    public = {
        "radiance": fused_ingest.encode_radiance, "normal": fused_ingest.encode_normal,
        "depth_alpha": fused_ingest.encode_depth_alpha, "depth": fused_ingest.encode_depth,
        "alpha": fused_ingest.encode_alpha,
    }[name]
    fused_ingest.reset_launches()
    got = public(*inputs)
    assert fused_ingest.launches[name] == 1
    assert sum(fused_ingest.launches.values()) == 1
    want = fused_ingest._PLAIN[name](*inputs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and _ingest_within(g_, w_)


AUX_SUBSETS = [(), ("depth",), ("alpha",), ("normal", "depth"), ("normal", "depth", "alpha")]


def _all_groups(pd):
    """The two seeded groups under all four group names."""
    for new, old in (("subsurface", "diffuse"), ("transmission", "glossy")):
        for part in ("direct", "indirect", "color"):
            pd[f"{new}_{part}"] = pd[f"{old}_{part}"].flip(0)
    return pd


@pytest.mark.parametrize("aux", AUX_SUBSETS, ids=str)
@pytest.mark.parametrize("lead", [(37, 53), (2, 20, 36)], ids=str)
def test_group_encode_writes_strided_channel_ranges(cuda, aux, lead):
    """encode_group_inputs_per_pass points the per-pass kernels at channel
    ranges of one preallocated stack (the strided-output path, with
    unaligned bases); encode_group_inputs_fused gives the same pixels in
    one launch of the whole-pixel kernel."""
    pd = _raw_passes(lead, cuda, seed=3)
    fused_ingest.reset_launches()
    got = fused_ingest.encode_group_inputs_per_pass(pd, "glossy", aux)
    n = dict(fused_ingest.launches)
    one = fused_ingest.encode_group_inputs_fused(pd, "glossy", aux)
    want = transforms.encode_group_inputs(pd, "glossy", aux)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _ingest_within(got, want)
    assert one.shape == want.shape and _ingest_within(one, want)
    assert n["radiance"] == 1 and n["normal"] == int("normal" in aux) and n["group_encode"] == 0
    both = "depth" in aux and "alpha" in aux
    assert n["depth_alpha"] == int(both)
    assert n["depth"] == int("depth" in aux and not both)
    assert n["alpha"] == int("alpha" in aux and not both)
    assert fused_ingest.launches == {**n, "group_encode": 1}


@pytest.mark.parametrize("aux", [*AUX_SUBSETS, ("alpha", "depth", "normal")], ids=str)
@pytest.mark.parametrize("n_groups", [1, 2, 3, 4])
@pytest.mark.parametrize("lead", [(64, 96), (2, 20, 36), (37, 53), (7, 9), (1, 1), (1080, 1920)],
                         ids=str)
def test_group_encode_kernel_matches_plain_version(cuda, lead, n_groups, aux):
    """The whole-pixel launch against the stacked plain encode: frame-sized
    (whole tiles), batched, and ragged shapes whose pixel count is no
    multiple of the tile, so that the later groups start off the float4
    grid and the last tile is short."""
    pd = _all_groups(_raw_passes(lead, cuda, seed=7))
    groups = ("diffuse", "glossy", "subsurface", "transmission")[:n_groups]
    fused_ingest.reset_launches()
    got = fused_ingest.encode_groups_fused(pd, groups, aux)
    assert fused_ingest.launches["group_encode"] == 1
    assert sum(fused_ingest.launches.values()) == 1
    want = torch.stack([transforms.encode_group_inputs(pd, g, aux) for g in groups], 0)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous() and _ingest_within(got, want)


def test_group_encode_kernel_takes_more_groups_than_one_launch_holds(cuda):
    pd = _all_groups(_raw_passes((37, 53), cuda, seed=8))
    groups = ("diffuse", "glossy", "subsurface", "transmission") * 3  # 12 > GROUP_CAPACITY
    fused_ingest.reset_launches()
    got = fused_ingest.encode_groups_fused(pd, groups)
    assert fused_ingest.launches["group_encode"] == 2
    want = torch.stack([transforms.encode_group_inputs(pd, g) for g in groups], 0)
    torch.cuda.synchronize()
    assert _ingest_within(got, want)


def test_group_encode_kernel_copies_sliced_inputs_and_writes_a_given_out(cuda):
    """Row-sliced and misaligned inputs get one dense copy each; a given
    `out` is written in place and nothing beside it; a strided or
    misaligned `out` raises."""
    pd = _all_groups(_raw_passes((50, 72), cuda, seed=9))
    sliced = {k: v[5:45:2] for k, v in pd.items()}
    flat = torch.rand(20 * 72 * 3 + 1, device=cuda) * 3 - 1.5
    sliced["normal"] = flat[1:].view(20, 72, 3)  # dense, 4 bytes off the float4 grid
    batch = torch.full((3, 2, 20, 72, 14), -7.0, device=cuda)
    groups = ("glossy", "subsurface")
    ret = fused_ingest.encode_groups_fused(sliced, groups, out=batch[1])
    want = torch.stack([transforms.encode_group_inputs(sliced, g) for g in groups], 0)
    torch.cuda.synchronize()
    assert ret.data_ptr() == batch[1].data_ptr() and _ingest_within(batch[1], want)
    assert bool((batch[0] == -7.0).all()) and bool((batch[2] == -7.0).all())
    fused_ingest.reset_launches()
    with pytest.raises(ValueError, match="strides"):
        fused_ingest.encode_groups_fused(
            sliced, groups, out=torch.empty((2, 20, 72, 28), device=cuda)[..., ::2])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_ingest.encode_groups_fused(
            sliced, groups,
            out=torch.empty(2 * 20 * 72 * 14 + 1, device=cuda)[1:].view(2, 20, 72, 14))
    with pytest.raises(ValueError, match="tensors on"):
        fused_ingest.encode_groups_fused({**sliced, "depth": sliced["depth"].cpu()}, groups)
    assert sum(fused_ingest.launches.values()) == 0


def test_ingest_kernel_reads_strided_inputs_and_writes_a_given_view(cuda):
    """Inputs that are channel ranges of a wider tensor (uniform pixel
    stride), a row-sliced input (copied dense) and an `out=` view."""
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.rand((40, 72, 9), generator=g, device=cuda) * 4 - 1
    d, i, c = wide[..., 0:3], wide[..., 3:6], wide[..., 6:9].clamp_min(0)
    stack = torch.full((40, 72, 8), -7.0, device=cuda)
    fused_ingest.encode_radiance(d, i, c, out=(stack[..., 1:4], stack[..., 4:7]))
    want_d, want_i = fused_ingest.encode_radiance_plain(d, i, c)
    rows = torch.rand((50, 72, 3), generator=g, device=cuda)[5:45:2] * 3 - 1.5
    got_rows = fused_ingest.encode_normal(rows)
    torch.cuda.synchronize()
    assert _ingest_within(stack[..., 1:4], want_d) and _ingest_within(stack[..., 4:7], want_i)
    assert bool((stack[..., 0] == -7.0).all()) and bool((stack[..., 7] == -7.0).all())
    assert _ingest_within(got_rows, fused_ingest.encode_normal_plain(rows))
    with pytest.raises(ValueError, match="uniform"):
        fused_ingest.encode_normal(rows, out=torch.empty((40, 72, 3), device=cuda)[::2])


def test_ingest_kernels_refuse_other_dtypes_and_mixed_devices(cuda):
    x = torch.rand((8, 8, 3), device=cuda)
    with pytest.raises(TypeError):
        fused_ingest.encode_normal(x.half())
    with pytest.raises(ValueError):
        fused_ingest.encode_radiance(x, x.cpu(), x)


def test_flagship_max_group_frame_on_the_card_matches_the_cpu_port(cuda):
    """The group frame at fp32 (TF32 off) with the fused ingest makes one
    group-encode launch (the bodies of K2-K4 inside it) and one K1 launch per
    slot, and agrees with the same port on the CPU (held to the JAX package
    by tests/test_torch_modes.py)."""
    h, w = 64, 96
    clean = synthetic.generate_clean_passes(h, w, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=6)
    cfg = config.validate_channels(config.PRESETS["flagship-max"])
    icfg = dataclasses.replace(cfg.infer, compute_dtype="float32", use_pallas_ingest=True)
    params = weights_io.load_release_params(REPO / "weights" / "kpn_ema_f16.npz")
    frame = {k: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in noisy.items()}
    with _full_fp32():
        den_gpu, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        fused_ingest.reset_launches()
        got = den_gpu(frame)
        torch.cuda.synchronize()
        assert kpn_apply.launches == cfg.model.kpn_slots
        assert fused_ingest.launches == {"radiance": 0, "normal": 0, "depth_alpha": 0,
                                         "depth": 0, "alpha": 0, "group_encode": 1}
    den_cpu, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, h, w, params, device="cpu")
    want = den_cpu(frame)
    assert set(got) == set(want)
    for name, ref in want.items():
        err = (got[name].cpu() - ref).abs().max()
        assert err <= 1e-4 * ref.abs().max(), (name, float(err))


# --------------------------------------------------------------------------
# the joint encode into the padded plane
# --------------------------------------------------------------------------

def _bits_equal(got, want) -> bool:
    """The same shape, NaN where the other has NaN, and every other element
    the same 32 bits."""
    if got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def _joint_passes(h, w, dev, seed=0, bad=True):
    """Every group's passes and the aux passes, reaching every clamp; with
    `bad`, pixel (1, 2), mirrored into the border, is NaN in every pass and
    pixel (h - 2, w - 1) +inf in every pass but the albedos."""
    pd = _all_groups(_raw_passes((h, w), dev, seed=seed))
    if bad:
        for k, v in pd.items():
            v = pd[k] = v.clone()
            v[1, 2] = float("nan")
            if not k.endswith("_color"):
                v[h - 2, w - 1] = float("inf")
    return pd


JOINT_PLANS = {  # (model preset, infer overrides, frame)
    "kpn-hq-1080p": ("kpn-hq", {}, (1080, 1920)),
    "kpn-hq-4k-tile-512": ("kpn-hq", dict(tile=512, tile_batch=8), (2160, 3840)),
    "odd-replicate": ("kpn-hq", dict(border=40), (37, 53)),
}


@pytest.mark.parametrize("plan", sorted(JOINT_PLANS))
def test_joint_encode_kernel_is_bit_equal_to_the_plain_plane(cuda, plan):
    """One launch writes pad_plane(encode_joint_inputs(...)) bit for bit at
    the 1080p whole-frame plan (1144x1984), the 4K tile-512 plan (2704x4240,
    bottom and right pads past the halo) and a small odd frame in replicate
    mode; a NaN and a +inf pixel of the inputs come out as the plain chain
    gives them, in the frame and in the border."""
    preset, infer_kw, (h, w) = JOINT_PLANS[plan]
    cfg = config.validate_channels(config.PRESETS[preset])
    grid = pipeline.plan_for(cfg.model, dataclasses.replace(cfg.infer, **infer_kw), h, w)
    mode = tiled.plane_pads(grid)[4]
    assert mode == ("replicate" if plan == "odd-replicate" else "reflect")
    pd = _joint_passes(h, w, cuda, seed=h)
    groups, aux = passes.LIGHT_GROUPS, passes.AUX_PASSES
    fused_ingest.reset_launches()
    got = fused_ingest.encode_joint_plane(pd, grid, groups, aux)
    assert fused_ingest.joint_encode_launches == 1 and sum(fused_ingest.launches.values()) == 0
    want = tiled.pad_plane(transforms.encode_joint_inputs(pd, groups, aux), grid)
    torch.cuda.synchronize()
    assert got.shape == (*tiled.plane_hw(grid), 41) and got.is_contiguous()
    assert _bits_equal(got, want)
    assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())


@pytest.mark.parametrize("aux", [*AUX_SUBSETS, ("alpha", "depth", "normal")], ids=str)
@pytest.mark.parametrize("n_groups", [1, 2, 3, 4])
def test_joint_encode_kernel_takes_every_group_count_and_aux_subset(cuda, n_groups, aux):
    """Each aux template of the kernel and each group count, in the caller's
    aux order, on a ragged frame whose last block is short."""
    pd = _joint_passes(29, 45, cuda, seed=n_groups)
    groups = passes.LIGHT_GROUPS[:n_groups]
    grid = tiled.plan_grid(29, 45, 0, 6, 2)  # a 42x58 plane: 2436 pixels
    fused_ingest.reset_launches()
    got = fused_ingest.encode_joint_plane(pd, grid, groups, aux)
    assert fused_ingest.joint_encode_launches == 1
    want = tiled.pad_plane(transforms.encode_joint_inputs(pd, groups, aux), grid)
    torch.cuda.synchronize()
    assert (got.numel() // got.shape[-1]) % 256 != 0
    assert _bits_equal(got, want)


def test_joint_encode_kernel_refuses_other_dtypes_and_mixed_devices(cuda):
    pd = _joint_passes(16, 24, cuda, bad=False)
    grid = tiled.plan_grid(16, 24, 0, 8, 8)
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.launch_joint_cuda({k: v.half() for k, v in pd.items()}, grid)
    with pytest.raises(ValueError, match="tensors on"):
        fused_ingest.launch_joint_cuda({**pd, "depth": pd["depth"].cpu()}, grid)
    fused_ingest.reset_launches()
    sliced = {k: torch.stack([v, v], 2)[:, :, 0] for k, v in pd.items()}  # strided views
    assert not any(v.is_contiguous() for v in sliced.values())
    got = fused_ingest.launch_joint_cuda(sliced, grid)
    assert fused_ingest.joint_encode_launches == 1
    assert _bits_equal(got, tiled.pad_plane(transforms.encode_joint_inputs(pd), grid))


JOINT_FRAMES = {  # preset, infer overrides, frame scale
    "kpn-hq-1080p": ("kpn-hq", {}, 1),
    "tiramisu-lt1-1080p": ("tiramisu-lt1", {}, 1),
    "kpn-hq-4k-tile-512": ("kpn-hq", dict(tile=512, tile_batch=8), 2),
}


@pytest.mark.parametrize("case", sorted(JOINT_FRAMES))
def test_joint_frames_launch_one_encode_and_equal_the_plain_route(cuda, fourier_1080p, case):
    """A release joint frame (bf16) through make_joint_frame_denoiser: one
    joint-encode launch a frame, the network on the kernel's plane, and
    every output pass equal to the same frame through the plain encode and
    frame_fn (the 4K frame: the 1080p frame mirrored 2x2, in lazy chunks)."""
    preset, infer_kw, scale = JOINT_FRAMES[case]
    cfg = config.validate_channels(config.PRESETS[preset])
    noisy = fourier_1080p["noisy"]
    if scale == 2:
        noisy = {k: _mirror_2x2(v) for k, v in noisy.items()}
    h, w = FRAME[0] * scale, FRAME[1] * scale
    den, _ = pipeline.make_joint_frame_denoiser(
        cfg.model, dataclasses.replace(cfg.infer, **infer_kw), h, w, _release_params(preset))
    assert den.on_plane is not None
    fused_ingest.reset_launches()
    tiled.reset_net_calls()
    got = den(noisy)
    torch.cuda.synchronize()
    assert fused_ingest.joint_encode_launches == 1
    net_calls = tiled.net_calls
    den.on_plane = None
    want = den(noisy)
    torch.cuda.synchronize()
    assert fused_ingest.joint_encode_launches == 1 and tiled.net_calls == 2 * net_calls
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _banded_kpn_hq(h, w):
    from deepdenoiser_tpu_torch.parallel import mesh

    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    icfg = dataclasses.replace(cfg.infer, spatial_shard=True)
    return pipeline.make_joint_frame_denoiser(
        cfg.model, icfg, h, w, _release_params("kpn-hq"),
        mesh=mesh.make_mesh(2, "spatial", devices=["cuda"] * 2))[0]


def _flags_frame(h, w):
    cfg = config.validate_channels(config.PRESETS["flagship-flags"])
    return pipeline.make_joint_frame_denoiser(
        cfg.model, cfg.infer, h, w, _seeded_params(cfg.model), groups=tuple(cfg.data.groups),
        use_flags=True)[0]


def _scaled_kpn_hq(h, w):
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    return pipeline.make_joint_frame_denoiser(
        cfg.model, cfg.infer, h, w, _release_params("kpn-hq"),
        scales={"radiance": 0.7, "depth": 0.25})[0]


@pytest.mark.parametrize("make", [_banded_kpn_hq, _flags_frame, _scaled_kpn_hq],
                         ids=["band-parallel", "use_flags", "scales"])
def test_joint_frames_the_kernel_cannot_serve_keep_the_plain_encode(cuda, make):
    """Band-parallel frames (the bands pad by themselves), flag planes and
    scaled encodes run the plain encode: no joint-encode launch, a finite
    frame."""
    h, w = 160, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    den = make(h, w)
    assert den.on_plane is None
    fused_ingest.reset_launches()
    out = den({k: torch.from_numpy(v) for k, v in noisy.items()})
    torch.cuda.synchronize()
    assert fused_ingest.joint_encode_launches == 0
    assert all(torch.isfinite(v).all() for v in out.values())


# --------------------------------------------------------------------------
# tiled frames
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 96, 96, 3), (3, 50, 70, 3)], ids=["tile-batch", "ragged"])
def test_kpn_kernel_matches_plain_version_on_a_tile_batch(cuda, shape):
    """The shape class of tiled frames: several network tiles per launch."""
    noisy, weights = _inputs(shape, 5, cuda, seed=2)
    kpn_apply.reset_launches()
    got = kpn_apply.apply_per_pixel_kernels(noisy, weights, 5)
    assert kpn_apply.launches == 1
    want = kpn.apply_per_pixel_kernels(noisy, weights, 5)
    torch.cuda.synchronize()
    assert _within(got, want)


@pytest.mark.parametrize("infer_kw,launches", [
    (dict(tile=32), 2),                  # 4 groups x 6 tiles in one batch, 2 slots
    (dict(tile=32, tile_batch=5), 10),   # 24 tiles in 5 chunks of 5
    (dict(tile=32, tile_batch=5, stitch="feather"), 10),
], ids=["tiled", "chunks", "feather"])
def test_tiled_group_frame_equals_the_whole_frame_on_the_card(cuda, infer_kw, launches):
    """A small `kpn` model (group mode, release weights), fp32 with TF32 off:
    the tiled frame equals the whole frame on the same padded plane, and the
    kernel is launched once per slot and tile batch. Feathering blends
    uncertified halo pixels in, so it is held close, not equal."""
    h, w = 64, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    cfg = config.validate_channels(config.PRESETS["kpn"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_ema_f16.npz")
    with _full_fp32():
        whole, _ = pipeline.make_group_frame_denoiser(
            cfg.model, dataclasses.replace(cfg.infer, compute_dtype="float32"), h, w, params)
        tiled_den, grid = pipeline.make_group_frame_denoiser(
            cfg.model, dataclasses.replace(cfg.infer, compute_dtype="float32", **infer_kw),
            h, w, params)
        assert (grid.rows, grid.cols) == (2, 3)
        want = whole(noisy)
        kpn_apply.reset_launches()
        got = tiled_den(noisy)
        torch.cuda.synchronize()
        assert kpn_apply.launches == launches
    assert set(got) == set(want)
    feather = infer_kw.get("stitch") == "feather"
    for name, ref in want.items():
        diff, scale = (got[name] - ref).abs(), float(ref.abs().max().clamp_min(1e-30))
        assert torch.isfinite(got[name]).all()
        if feather:
            assert float(diff.max()) <= 0.1 * scale and float(diff.mean()) <= 2e-3 * scale, name
        else:
            assert float(diff.max()) <= 1e-4 * scale, (name, float(diff.max()))


# --------------------------------------------------------------------------
# the KPN filter apply's backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k", [((1, 37, 53, 3), 5), ((2, 20, 36, 1), 3), ((1, 9, 7, 4), 5),
                                     ((16, 96, 96, 3), 5)],
                         ids=["odd", "k3-c1", "c4", "train-batch"])
def test_kpn_backward_kernels_match_plain_version(cuda, shape, k):
    noisy, weights = _inputs(shape, k, cuda, seed=3)
    g = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    kpn_apply.reset_launches()
    d_w = kpn_apply.bwd_weights_cuda(noisy, g, k)
    d_noisy = kpn_apply.bwd_noisy_cuda(g, weights, k)
    assert (kpn_apply.bwd_weights_launches, kpn_apply.bwd_noisy_launches) == (1, 1)
    want_noisy, want_w = kpn.apply_per_pixel_kernels_bwd(noisy, weights, g, k, True)
    torch.cuda.synchronize()
    assert d_w.shape == want_w.shape and d_noisy.shape == want_noisy.shape
    assert _within(d_w, want_w) and _within(d_noisy, want_noisy)


def test_kpn_autograd_on_the_card_launches_only_the_gradients_asked_for(cuda):
    """The head's views, as in training: the signal is a slice of the input
    (no gradient), the weights a contiguous softmax over the last axis."""
    k = 5
    gen = torch.Generator(device=cuda).manual_seed(5)
    stack = torch.rand((2, 24, 40, 24), generator=gen, device=cuda)
    logits = torch.randn((2, 24, 40, k * k), generator=gen, device=cuda, requires_grad=True)
    g = torch.randn((2, 24, 40, 3), generator=gen, device=cuda)
    kpn_apply.reset_launches()
    out = kpn_apply.apply_per_pixel_kernels(stack[..., 3:6], torch.softmax(logits, -1), k)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (kpn_apply.launches, kpn_apply.bwd_weights_launches, kpn_apply.bwd_noisy_launches) == (1, 1, 0)
    ref_logits = logits.detach().cpu().requires_grad_()
    ref = kpn.apply_per_pixel_kernels(stack[..., 3:6].cpu(), torch.softmax(ref_logits, -1), k)
    (ref * g.cpu()).sum().backward()
    assert _within(logits.grad.cpu(), ref_logits.grad)
    with torch.inference_mode():
        kpn_apply.reset_launches()
        kpn_apply.apply_per_pixel_kernels(stack[..., 3:6], torch.softmax(logits, -1), k)
        assert (kpn_apply.launches, kpn_apply.bwd_weights_launches) == (1, 0)


@pytest.mark.parametrize("lead,k,slots,norm,crop", [
    ((1, 37, 53), 5, 8, True, False), ((4, 20, 36), 5, 2, True, False),
    ((2, 19, 21), 3, 2, True, False), ((3, 9, 7), 3, 1, False, False),
    ((2, 30, 41), 5, 8, False, True), ((1, 1, 3), 5, 8, True, False),
    # the frame cells' heads: kpn-hq's plane, flagship-max's four groups, a 4K tile batch
    ((1, 1144, 1984), 5, 8, True, False), ((4, 1144, 1984), 5, 2, True, False),
    ((8, 656, 656), 5, 8, True, False)])
def test_kpn_softmax_kernel_matches_plain_version(cuda, lead, k, slots, norm, crop):
    """Every slot view of an (N,H,W,slots·k²) output, ragged pixel counts,
    and a cropped view whose N, H and W strides do not merge."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    k2 = k * k
    feats = 3 * torch.randn((*lead, slots * k2), generator=gen, device=cuda)
    if crop:
        feats = feats[:, 2:-1, 1:-3, :]
    taus = 16 * torch.sigmoid(2 * torch.randn((slots,), generator=gen, device=cuda)) if norm else None
    kpn_softmax.reset_launches()
    for s in range(slots):
        logits = feats[..., s * k2 : (s + 1) * k2]
        tau = taus[s] if norm else None
        got = kpn_softmax.KpnSoftmax.apply(logits, tau)
        want = kpn_softmax.softmax_plain(logits, tau)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == want.shape
        # the same fp32 operations, sums in another order; exp carries z's rounding
        assert bool(torch.all((got - want).abs() <= 1e-6 + 1e-4 * want.abs()))
        assert torch.equal(got, kpn_softmax.softmax_cuda(logits, tau))
    assert kpn_softmax.launches == 2 * slots


def test_kpn_head_on_the_card_launches_one_softmax_a_slot_and_the_plain_gradients(cuda):
    """kpn-hq's head (8 slots of 5x5, RMS-normed logits): 8 launches a
    forward, and the gradients of the logits and the temperatures those of
    the same head on the CPU."""
    k, slots = 5, 8
    gen = torch.Generator().manual_seed(8)
    feats = 3 * torch.randn((2, 16, 24, slots * k * k), generator=gen)
    signal = torch.rand((2, 16, 24, 3 * slots), generator=gen)
    cot = torch.randn((2, 16, 24, 3 * slots), generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        head = kpn.KernelPredictionHead(k, slots, logit_norm=True).to(dev)
        with torch.no_grad():
            head.kernel_temp.copy_(torch.linspace(-2.0, 2.0, slots))
        f = feats.to(dev, copy=True).requires_grad_()
        kpn_softmax.reset_launches()
        out = head(f, signal.to(dev))
        assert kpn_softmax.launches == (slots if dev == cuda else 0)
        (out * cot.to(dev)).sum().backward()
        grads[str(dev)] = (f.grad.cpu(), head.kernel_temp.grad.cpu())
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("slots", [8, 2], ids=["kpn-hq", "flagship-max"])
def test_kpn_head_on_the_card_runs_no_kernel_of_the_plain_chain(cuda, slots):
    """The heads of kpn-hq and flagship-max: one norm-and-softmax launch a
    slot, as counted and in the profiler's trace, and none of the softmax
    or reduction kernels of the plain chain."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(18)
    head = kpn.KernelPredictionHead(5, slots, logit_norm=True).to(cuda)
    feats = 3 * torch.randn((2, 24, 40, slots * 25), generator=gen, device=cuda)
    signal = torch.rand((2, 24, 40, 3 * slots), generator=gen, device=cuda)
    kpn_softmax.reset_launches()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        head(feats, signal)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kpn_softmax.launches == slots
    assert sum(e.count for e in kernels if "kpn_softmax_kernel" in e.key) == slots
    assert not [e.key for e in kernels if "softmax_warp" in e.key or "reduce_kernel" in e.key]


def _slot_inputs(shape, k, dev, stack, slot, seed=0):
    """noisy and g as channels C*slot.. of (N,H,W,stack) tensors (the train
    step's slot views; stack=None: (N,H,W,C) of their own), and the
    weights as the permuted view of a planar softmax, as the head passes
    them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, h, w, c = shape
    if stack is None:
        noisy = torch.rand(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
    else:
        noisy = torch.rand((n, h, w, stack), generator=gen, device=dev)[..., c * slot : c * (slot + 1)]
        g = torch.randn((n, h, w, stack), generator=gen, device=dev)[..., c * slot : c * (slot + 1)]
    logits = torch.randn((n, k * k, h, w), generator=gen, device=dev)
    return noisy, torch.softmax(logits, 1).permute(0, 2, 3, 1), g


def _backward_matches(noisy, weights, g, k):
    kpn_apply.reset_launches()
    d_w = [kpn_apply.bwd_weights_cuda(noisy, g, k) for _ in range(2)]
    d_noisy = [kpn_apply.bwd_noisy_cuda(g, weights, k) for _ in range(2)]
    assert (kpn_apply.bwd_weights_launches, kpn_apply.bwd_noisy_launches) == (2, 2)
    want_noisy, want_w = kpn.apply_per_pixel_kernels_bwd(noisy, weights, g, k, True)
    torch.cuda.synchronize()
    assert d_w[0].shape == want_w.shape and d_noisy[0].shape == want_noisy.shape
    # both in the head's layout: d_w (N,H,W,k²) as the softmax's backward takes it
    assert d_noisy[0].is_contiguous() and d_w[0].is_contiguous()
    assert _within(d_w[0], want_w) and _within(d_noisy[0], want_noisy)
    # a second launch is bitwise the same (no atomics, a fixed summation order)
    assert torch.equal(d_w[0], d_w[1]) and torch.equal(d_noisy[0], d_noisy[1])


@pytest.mark.parametrize("slot", range(8))
def test_kpn_backward_kernels_take_every_slot_view(cuda, slot):
    """Slot s of the joint model's 24-channel signal and output gradient:
    a base 12*s bytes into a 96 B pixel, 16 B aligned for slots 0 and 4
    only; slots 2 and 5 straddle two 32 B sectors."""
    _backward_matches(*_slot_inputs((2, 20, 40, 3), 5, cuda, 24, slot), 5)


@pytest.mark.parametrize("shape,k,stack,slot", [
    ((1, 17, 37, 3), 5, 24, 3),     # W not a multiple of 4 nor of the 32-pixel tile
    ((2, 9, 6, 3), 5, 24, 1),       # W under one tile and not a multiple of 4
    ((2, 9, 12, 3), 3, 14, 1),      # W under one tile, a multiple of 4; a group-mode slot
    ((1, 1, 45, 3), 5, 24, 6),      # H = 1
    ((16, 96, 96, 3), 3, 24, 5),    # the training batch at k = 3
    ((16, 8, 40, 3), 5, 24, 2),     # N = 16
    ((1, 13, 40, 1), 5, 4, 2),      # C = 1
    ((1, 13, 41, 2), 3, 4, 1),      # C = 2, ragged
    ((2, 11, 36, 4), 5, None, 0),   # C = 4: W*C a multiple of 4, 16 B rows
    ((1, 11, 33, 4), 3, 8, 1),      # C = 4, ragged
    ((16, 96, 96, 3), 5, 24, 2),    # the training batch at k = 5, a slot over two sectors
    ((1, 1144, 1984, 3), 5, 24, 0),  # the joint 1080p plane
], ids=str)
def test_kpn_backward_kernels_on_ragged_narrow_and_strided_frames(cuda, shape, k, stack, slot):
    _backward_matches(*_slot_inputs(shape, k, cuda, stack, slot, seed=slot + 1), k)


def test_kpn_backward_kernels_take_contiguous_weights(cuda):
    """(N,H,W,k²) weights of their own (no planar rows): d_noisy loads
    each tap through the strides."""
    noisy, weights = _inputs((2, 19, 40, 3), 5, cuda, seed=6)
    g = torch.randn(noisy.shape, generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    _backward_matches(noisy, weights.contiguous(), g, 5)


def _device_copies(run) -> tuple:
    """(copy kernels and memcpys that `run` launches, what it returns)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("direct_copy" in e.key or "Memcpy" in e.key)), out


def test_kpn_head_backward_makes_no_copy_of_the_weight_gradient(cuda, monkeypatch):
    """kpn-hq's head (8 slots of 5x5, RMS-normed logits) on the card: the
    softmax's backward takes d_w as the kernel wrote it. With d_w made
    planar on purpose (the layout the kernel wrote before) the same
    backward launches two more copies a slot: the one that makes it
    planar, and the softmax's transposing copy back."""
    k, slots = 5, 8
    gen = torch.Generator(device=cuda).manual_seed(9)
    feats = torch.randn((2, 24, 40, slots * k * k), generator=gen, device=cuda)
    signal = torch.rand((2, 24, 40, 3 * slots), generator=gen, device=cuda)
    cot = torch.randn((2, 24, 40, 3 * slots), generator=gen, device=cuda)
    head = kpn.KernelPredictionHead(k, slots, logit_norm=True).to(cuda)
    nhwc = kpn_apply.bwd_weights_cuda

    def planar(noisy, g, kernel_size):
        return nhwc(noisy, g, kernel_size).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    copies, grads = {}, {}
    for name, fn in (("nhwc", nhwc), ("planar", planar)):
        monkeypatch.setattr(kpn_apply, "bwd_weights_cuda", fn)
        f = feats.clone().requires_grad_()
        loss = (head(f, signal) * cot).sum()
        kpn_apply.reset_launches()
        # the features' gradient only: no parameter's first accumulation
        # adds a copy to one run and not the other
        copies[name], grads[name] = _device_copies(lambda: torch.autograd.grad(loss, f)[0])
        assert kpn_apply.bwd_weights_launches == slots
    assert copies["planar"] - copies["nhwc"] == 2 * slots, copies
    assert torch.equal(grads["nhwc"], grads["planar"])


def test_kpn_backward_kernels_fill_the_card_at_the_training_batch(cuda):
    """At (16,96,96,3), k=5, both kernels launch 1152 blocks of 32x4
    pixels. d_w's are all resident at once: no partial second wave.
    d_noisy's staged weight window (34 KB) holds 6 blocks an SM: 792 of
    the 1152 in the first wave, every SM full."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = 16 * (96 // 4) * (96 // 32)
    assert kpn_apply.resident_blocks("bwd_weights", 5, 3) * sms >= tiles
    assert kpn_apply.resident_blocks("bwd_noisy", 5, 3) >= 6


@pytest.mark.parametrize("seed", [0, 4, 5, 11])
def test_tracer_on_the_card_matches_the_cpu_tracer_under_the_flip_bar(cuda, seed):
    """The deterministic buffers of one scene traced on the card and on the
    CPU agree but for pixels that flip at a silhouette or checker edge."""
    frames = [{k: v.cpu().numpy() for k, v in
               mc_tracer.render(mc_tracer.make_scene(seed, device=dev), 48, 64, 1,
                                seeded(0, dev)).items()}
              for dev in (cuda, "cpu")]
    torch_flips.assert_flips_only(*frames)


@pytest.mark.parametrize("family", synthetic_device.FAMILIES)
def test_training_batch_stays_on_the_card_without_a_host_sync(cuda, monkeypatch, family):
    """Every tensor is made on the card, finite, and no operation waits for
    the card (torch's sync debug mode raises on one)."""
    monkeypatch.setattr(synthetic_device, "MC_TRAIN_GT_SPP", 16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = synthetic_device.training_batch(gen, 6, 32, "joint", family)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert batch["x"].shape == (6, 32, 32, transforms.joint_input_channels())
    assert batch["y"].shape == (6, 32, 32, transforms.joint_output_channels())
    for v in batch.values():
        assert v.device.type == "cuda" and bool(torch.isfinite(v).all())


# --------------------------------------------------------------------------
# multi-device paths on the one card
# --------------------------------------------------------------------------


def test_band_parallel_kpn_frame_on_the_card_equals_the_whole_frame(cuda):
    """kpn-hq in 2 bands on ["cuda"] * 2 (fp32, TF32 off): 8 filter-apply
    launches a band, and the frame equals the one-device frame with the
    certified halo."""
    from deepdenoiser_tpu_torch.parallel import mesh

    h, w = 160, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    icfg = dataclasses.replace(cfg.infer, compute_dtype="float32", spatial_shard=True)
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    frame = {k: torch.from_numpy(v) for k, v in noisy.items()}
    with _full_fp32():
        banded, _ = pipeline.make_joint_frame_denoiser(
            cfg.model, icfg, h, w, params, mesh=mesh.make_mesh(2, "spatial", devices=["cuda"] * 2))
        whole, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        got = banded(frame)
        torch.cuda.synchronize()
        assert kpn_apply.launches == 2 * cfg.model.kpn_slots
        want = whole(frame)
    for k, ref in want.items():
        assert float((got[k] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), k


def test_two_gloo_ranks_on_the_card_match_the_one_rank_step(cuda, tmp_path):
    """Two data-parallel ranks share the card over gloo (NCCL refuses two
    ranks on one card); three steps equal the one-rank step on the global
    batch, and each rank launches the filter apply and its d_w 8 times a
    step."""
    import torch_dp_worker
    from deepdenoiser_tpu_torch.models import factory
    from deepdenoiser_tpu_torch.training import train

    mkw = dict(backbone="unet", in_channels=41, out_channels=24, base_width=8, depth=1,
               convs_per_level=1, kernel_prediction=True, kpn_size=5, kpn_slots=8,
               kpn_logit_norm=True, act="leaky_relu")
    tkw = dict(learning_rate=2e-4, warmup_steps=0, ema_decay=0.9, steps=200)
    m, t = factory.ModelConfig(**mkw), config.TrainConfig(**tkw)
    params = weights_io.flatten(weights_io.params_from_state_dict(
        factory.init_model(m, torch.Generator().manual_seed(0)).state_dict()))
    rng = np.random.default_rng(1)
    batch = {"x": rng.random((8, 32, 32, 41)).astype(np.float32),
             "y": rng.random((8, 32, 32, 24)).astype(np.float32)}
    res = torch_dp_worker.spawn(torch_dp_worker.train_steps, 2, tmp_path, "cuda",
                                mkw, tkw, params, batch, 3)
    assert all(launches == (8, 8) for r in res for launches in r["launches"])
    with _full_fp32():
        state = train.create_state(m, t, params=weights_io.unflatten(params))
        step = train.make_train_step(m, t)
        for got in res[0]["mets"]:
            state, want = step(state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
            for k in ("loss", "grad_norm"):
                assert got[k] == pytest.approx(float(want[k]), rel=1e-5), k
    want = torch_dp_worker.flat_state(state)
    for k, v in res[0]["state"].items():
        np.testing.assert_array_equal(res[1]["state"][k], v, err_msg=k)
        if k.startswith(("params/", "ema/")):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("fam", ["kpn", "multiscale", "tiramisu", "unet"])
def test_tf_goldens_hold_on_the_card(cuda, fam):
    """The JAX package's frozen TF checkpoints, read without TensorFlow and
    forwarded on the card in fp32: the kpn family's 3x3, 2-slot head
    launches the filter apply once a slot."""
    from deepdenoiser_tpu_torch.compat import goldens

    kpn_apply.reset_launches()
    assert goldens.check(fam, device=cuda) <= goldens.ATOL
    assert kpn_apply.launches == (2 if fam == "kpn" else 0)


@pytest.mark.parametrize("fam", ["kpn", "multiscale", "tiramisu", "unet"])
def test_goldens_made_on_the_card_hold_on_the_card(cuda, fam, tmp_path):
    """goldens.make on the card (fp32, TF32 off), read back by goldens.check
    on the card; the kpn family launches the filter apply twice in each.
    The card's y holds against the CPU's forward of the same checkpoint
    (the plain filter apply, no cuDNN), and the checkpoint's bytes are a
    CPU make's."""
    from deepdenoiser_tpu_torch.compat import goldens

    kpn_apply.reset_launches()
    goldens.make(fam, tmp_path / "card" / fam)
    assert kpn_apply.launches == (2 if fam == "kpn" else 0)
    assert goldens.check(fam, indir=tmp_path / "card", device=cuda) <= goldens.ATOL
    assert kpn_apply.launches == (4 if fam == "kpn" else 0)
    assert goldens.check(fam, indir=tmp_path / "card", device="cpu") <= goldens.ATOL
    goldens.make(fam, tmp_path / "cpu" / fam, device="cpu")
    for name in ("model.ckpt.index", "model.ckpt.data-00000-of-00001"):
        assert ((tmp_path / "card" / fam / name).read_bytes()
                == (tmp_path / "cpu" / fam / name).read_bytes()), name


def test_tf_bundle_round_trip_of_release_weights_on_the_card(cuda, tmp_path):
    """kpn-hq's release weights through the port's TF writer and reader are
    bit-equal, and so is the model's output on the card (8 launches each)."""
    from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
    from deepdenoiser_tpu_torch.models import factory

    cfg = config.validate_channels(config.PRESETS["kpn-hq"]).model
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    tfc.export_checkpoint(params, cfg, tmp_path / "model.ckpt")
    back = tfc.import_checkpoint(tmp_path / "model.ckpt", cfg)
    want = weights_io.flatten(params)
    assert sorted(weights_io.flatten(back)) == sorted(want)
    for k, v in weights_io.flatten(back).items():
        assert v.tobytes() == want[k].tobytes(), k
    x = torch.rand((1, 64, 96, cfg.in_channels), generator=torch.Generator().manual_seed(0))
    outs = []
    for tree in (params, back):
        model = factory.build_model(cfg)
        weights_io.load_into(model, tree)
        kpn_apply.reset_launches()
        with torch.no_grad():
            outs.append(model.to(cuda).eval()(x.to(cuda)))
        torch.cuda.synchronize()
        assert kpn_apply.launches == 8
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()


def test_recipe_on_the_card_launches_the_kernels_in_its_steps_and_validation(cuda, tmp_path,
                                                                            monkeypatch):
    """kpn-hq through the port's recipe at a small crop, with --init-from and
    a teacher: 8 filter-apply and 8 d_w launches a step, 8 filter-apply
    launches a validation batch, counted apart."""
    from deepdenoiser_tpu_torch.tools import pretrain_flagship
    from deepdenoiser_tpu_torch.training import train as train_lib

    in_eval = []
    make_eval = train_lib.make_eval_step

    def counted(*a, **kw):
        fn = make_eval(*a, **kw)

        def run(*args):
            before = kpn_apply.launches
            out = fn(*args)
            in_eval.append(kpn_apply.launches - before)
            return out
        return run

    monkeypatch.setattr(train_lib, "make_eval_step", counted)
    kpn_apply.reset_launches()
    res = pretrain_flagship.main([
        "--model", "kpn-hq", "--crop", "32", "--batch", "2", "--steps", "2", "--val-every", "2",
        "--log-every", "1", "--out", str(tmp_path / "run"), "--teacher", "flagship-hq",
        "--init-from", str(REPO / "weights" / "kpn_hq_ema_f16.npz")])
    assert res == 0
    assert in_eval == [8] * pretrain_flagship.VAL_BATCHES
    assert kpn_apply.launches - sum(in_eval) == 2 * 8
    assert kpn_apply.bwd_weights_launches == 2 * 8 and kpn_apply.bwd_noisy_launches == 0
    assert (tmp_path / "run-best" / "2" / "extra.json").is_file()


def test_roofline_of_a_kpn_hq_frame_on_the_card(cuda, capsys):
    """The whole-frame roofline of kpn-hq at 1080p: FLOPs counted from the
    shapes over the frame's CUDA-event latency, a share of the card's bf16
    peak in (0, 1]; the frame launches K1 eight times."""
    import json

    from deepdenoiser_tpu_torch.tools import roofline

    kpn_apply.reset_launches()
    assert roofline.main(["--model", "kpn-hq", "--border", "32", "--chain", "2"]) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):])
    assert 0 < rep["mfu"] <= 1 and 0 < rep["hbm_utilization"] <= 1.05
    assert rep["device"] == torch.cuda.get_device_name(0) and rep["weights"] == "release"
    assert kpn_apply.launches % 8 == 0 and kpn_apply.launches > 0


# --------------------------------------------------------------------------
# the conv epilogue: bias and activation in one pass
# --------------------------------------------------------------------------

PLANE = (1144, 1984)  # the 1080p frame cells' network plane (border 32)
# conv epilogue launches a network call: one a ConvBlock and one for the 1x1
# head; unet-multiscale runs its base UNet at three scales
EPILOGUES = {"kpn-hq": 21, "flagship-hq": 21, "flagship": 21, "flagship-mc": 21,
             "flagship-max": 21, "kpn": 21, "tiramisu-lt1": 33, "tiramisu-fast": 39,
             "tiramisu": 36, "unet-multiscale": 63, "rgb-small": 10}
# the frame cells' network calls: (preset, the batch (N, H, W) of one call)
EPILOGUE_PATHS = {"kpn-hq": ("kpn-hq", (1, *PLANE)), "flagship-max": ("flagship-max", (4, *PLANE)),
                  "tiramisu-lt1": ("tiramisu-lt1", (1, *PLANE)),
                  "kpn-hq-4k-tiles": ("kpn-hq", (8, 656, 656))}
EXACT_ACTS = ("leaky_relu", "relu", "none")


@functools.lru_cache(maxsize=None)
def _epilogue_shapes(path: str) -> dict:
    """The distinct (N,C,H,W) conv outputs of a frame cell's network call
    (EPILOGUE_PATHS), read off one forward on the card at random weights:
    {"plain": those the epilogue takes in place, "subpixel": the phase
    tensors of the resize-convs}."""
    preset, lead = EPILOGUE_PATHS[path]
    mcfg = config.validate_channels(config.PRESETS[preset]).model
    model = factory.init_model(mcfg, torch.Generator().manual_seed(0)).to("cuda")
    x = torch.rand((*lead, mcfg.in_channels), device="cuda")
    shapes = {"plain": [], "subpixel": []}
    ops = {"plain": ("bias_act", bias_act.bias_act),
           "subpixel": ("bias_act_subpixel", bias_act.bias_act_subpixel)}

    def seen(kind):
        def call(z, b, act):
            shapes[kind].append(tuple(z.shape))
            return ops[kind][1](z, b, act)
        return call

    try:
        for kind, (name, _) in ops.items():
            setattr(bias_act, name, seen(kind))
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for name, op in ops.values():
            setattr(bias_act, name, op)
    assert len(shapes["plain"]) + len(shapes["subpixel"]) == EPILOGUES[preset]
    return {kind: tuple(sorted(set(v))) for kind, v in shapes.items()}


def _ulps(got, want) -> int:
    """The largest distance in units in the last place between two bf16 or
    fp32 tensors (the bit patterns on one monotonic integer line)."""
    itype = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    bits = [t.contiguous().view(itype).long() for t in (got, want)]
    top = 1 << (8 * got.element_size() - 1)
    keys = [torch.where(b >= 0, b, -(b + top)) for b in bits]
    return int((keys[0] - keys[1]).abs().max())


def _epilogue_matches(z, b, act):
    """The kernel in place on a copy of z against the plain version: equal
    for leaky_relu, relu and none; within 1 ulp for elu, gelu and silu,
    whose expm1f, tanhf and expf may round otherwise than PyTorch's build
    (FMA contraction, the order of the operations). The result is the
    copy's storage."""
    out = z.clone()
    ptr = out.data_ptr()
    got = bias_act.bias_act_cuda(out, b, act, out)
    want = bias_act.bias_act_plain(z, b, act)
    torch.cuda.synchronize()
    assert got is out and got.data_ptr() == ptr and got.stride() == z.stride()
    if act in EXACT_ACTS:
        assert torch.equal(got, want), act
    else:
        assert _ulps(got, want) <= 1, act


@pytest.mark.parametrize("act", sorted(bias_act.ACTIVATIONS))
@pytest.mark.parametrize("path", list(EPILOGUE_PATHS))
def test_bias_act_kernel_matches_plain_version_at_every_backbone_shape(cuda, path, act):
    """Every conv output shape of the four frame cells' network calls (the
    1080p plane, a chunk of eight 4K tiles), bf16, channels-last as the
    path lays them out."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    shapes = _epilogue_shapes(path)["plain"]
    bias_act.reset_launches()
    for shape in shapes:
        z = (3 * torch.randn(shape, generator=gen, device=cuda)).to(torch.bfloat16)
        z = z.contiguous(memory_format=torch.channels_last)
        b = torch.randn((shape[1],), generator=gen, device=cuda)
        _epilogue_matches(z, b, act)
        del z
    assert bias_act.launches == len(shapes)


@pytest.mark.parametrize("act", sorted(bias_act.ACTIVATIONS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,layout", [
    ((2, 50, 37, 53), "channels_last"),   # 50 channels: vectors straddle pixels
    ((2, 50, 37, 53), "nchw"),
    ((3, 16, 5, 7), "nchw"),              # H*W = 35: vectors straddle channels
    ((1, 7, 3, 3), "channels_last"),      # 63 elements: under one vector a thread
    ((1, 3, 1, 1), "nchw"),
], ids=["c50-nhwc", "c50-nchw", "hw35-nchw", "ragged", "tiny"])
def test_bias_act_kernel_on_layouts_dtypes_and_ragged_tensors(cuda, shape, layout, dtype, act):
    gen = torch.Generator(device=cuda).manual_seed(21)
    n, c, h, w = shape
    z = (3 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    if layout == "channels_last":
        z = z.contiguous(memory_format=torch.channels_last)
    b = torch.randn((c,), generator=gen, device=cuda)
    _epilogue_matches(z, b, act)
    if dtype == torch.bfloat16:  # a bias already in the working dtype
        _epilogue_matches(z, b.to(dtype), act)


@pytest.mark.parametrize("entry", ["bias_act", "bias_act_cuda"])
def test_bias_act_refuses_a_misaligned_tensor_on_the_card(cuda, entry):
    flat = torch.randn((1 + 2 * 64 * 20 * 36,), device=cuda).to(torch.bfloat16)
    z = flat[1:].view(2, 64, 20, 36)
    b = torch.randn((64,), device=cuda)
    bias_act.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if entry == "bias_act":
            bias_act.bias_act(z, b, "leaky_relu")
        else:
            bias_act.bias_act_cuda(z, b, "leaky_relu", z)
    assert bias_act.launches == 0


def test_bias_act_writes_in_place_without_grad_and_anew_under_it(cuda):
    z = torch.randn((1, 64, 40, 72), device=cuda).to(torch.bfloat16)
    z = z.contiguous(memory_format=torch.channels_last)
    b = torch.randn((64,), device=cuda, requires_grad=True)
    want = bias_act.bias_act_plain(z, b.detach(), "leaky_relu")
    bias_act.reset_launches()
    with torch.no_grad():
        same = z.clone()
        assert bias_act.bias_act(same, b, "leaky_relu") is same
    out = bias_act.bias_act(z, b, "leaky_relu")
    torch.cuda.synchronize()
    assert out.data_ptr() != z.data_ptr() and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(same, want) and torch.equal(out, want)
    assert bias_act.launches == 2


def _plain_epilogue(z, b, act):
    return bias_act.bias_act_plain(z, b, act)


def _plain_subpixel_epilogue(z, b, act):
    return bias_act.bias_act_subpixel_plain(z, b, act)


def test_kpn_hq_1080p_frame_equals_the_plain_epilogue_bit_for_bit(cuda, fourier_1080p,
                                                                  monkeypatch):
    """The release kpn-hq frame denoiser (bf16) at 1080p: 21 launches a
    frame, 3 of them the resize-convs' sub-pixel epilogue, and every output
    pass equal to the same frame with the plain chains (the plain
    interleave included) in the kernel's place."""
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    frame = fourier_1080p["noisy"]
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, 1080, 1920, params)
    bias_act.reset_launches()
    got = den(frame)
    torch.cuda.synchronize()
    assert bias_act.launches == 21 and bias_act.subpixel_launches == 3
    monkeypatch.setattr(bias_act, "bias_act", _plain_epilogue)
    monkeypatch.setattr(bias_act, "bias_act_subpixel", _plain_subpixel_epilogue)
    want = den(frame)
    assert bias_act.launches == 21 and bias_act.subpixel_launches == 3
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("preset,weights", [("kpn-hq", "kpn_hq_ema_f16.npz"),
                                            ("tiramisu-lt1", "tiramisu_lt1_ema_f16.npz")])
def test_frame_denoisers_launch_one_epilogue_a_conv(cuda, preset, weights):
    """Counted by the wrapper, and as bias_act_kernel in the profiler's
    trace of the second frame."""
    from torch.profiler import ProfilerActivity, profile

    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(REPO / "weights" / weights)
    h, w = 64, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    frame = {k: torch.from_numpy(v) for k, v in noisy.items()}
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, h, w, params)
    bias_act.reset_launches()
    den(frame)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        den(frame)
        torch.cuda.synchronize()
    assert bias_act.launches == 2 * EPILOGUES[preset]
    assert sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "bias_act_kernel" in e.key) == EPILOGUES[preset]


def test_train_step_with_the_kernel_equals_the_plain_epilogue(cuda, monkeypatch):
    """One make_train_step step of a small joint KPN in bf16 (cuDNN's
    deterministic algorithms): the loss, the gradient norm and every
    parameter after the update equal those of the same step with the plain
    chain in the kernel's place."""
    from deepdenoiser_tpu_torch.models.factory import ModelConfig
    from deepdenoiser_tpu_torch.training import train as train_lib

    mcfg = ModelConfig(backbone="unet", in_channels=41, out_channels=24, base_width=16, depth=2,
                       kernel_prediction=True, kpn_size=5, kpn_slots=8, kpn_logit_norm=True,
                       act="leaky_relu", compute_dtype="bfloat16")
    tcfg = config.TrainConfig(learning_rate=1e-3, warmup_steps=0, schedule="constant")
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((4, 64, 64, 41), generator=gen)
    sig = torch.cat([x[..., 9 * g : 9 * g + 6] for g in range(4)], dim=-1)
    batch = {k: v.to(cuda) for k, v in
             {"x": x, "y": sig + 0.05 * torch.randn(sig.shape, generator=gen)}.items()}
    step = train_lib.make_train_step(mcfg, tcfg)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            if plain:
                monkeypatch.setattr(bias_act, "bias_act", _plain_epilogue)
            state = train_lib.create_state(mcfg, tcfg, seed=0)
            bias_act.reset_launches()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            runs.append((bias_act.launches, metrics, state.params))
    finally:
        torch.backends.cudnn.deterministic = prev
    (launched, got_m, got_p), (none, want_m, want_p) = runs
    assert launched == 15 and none == 0  # 14 ConvBlocks and the head, forward only
    for k in ("loss", "grad_norm"):
        assert torch.equal(got_m[k], want_m[k]), k
    for name, p in want_p.items():
        assert torch.equal(got_p[name], p), name


@pytest.mark.parametrize("cin,cout,kernel,stride,act", [
    (41, 64, 3, 1, "leaky_relu"),   # kpn-hq's first conv
    (64, 128, 3, 2, "leaky_relu"),  # its first downsample
    (64, 200, 1, 1, "none"),        # its 1x1 head
    (48, 16, 3, 1, "leaky_relu"),   # a tiramisu dense layer
], ids=["3x3", "3x3-s2", "1x1-head", "3x3-c16"])
def test_conv_epilogue_equals_the_conv_with_its_bias_bit_for_bit(cuda, cin, cout, kernel, stride,
                                                               act):
    """The bias-less conv and the kernel against F.conv2d with the bias, as
    the port ran it before the kernel (PyTorch adds the bias after cuDNN's
    conv), bf16 channels-last at the 1080p plane: the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    x = torch.randn((1, cin, *PLANE), generator=gen, device=cuda).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    block = layers.ConvBlock(cin, cout, kernel, stride, act=act, dtype=torch.bfloat16).to(cuda)
    conv = block.Conv_0
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
        w, b = conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16)
        inp, kw = x, dict(padding=kernel // 2)
        if stride == 2:  # XLA's SAME pads an even input (0, 1)
            inp = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
            kw = dict(stride=2)
        want = bias_act.ACTIVATIONS[act](F.conv2d(inp, w, b, **kw))
        got = block(x)
        op = bias_act.bias_act(F.conv2d(inp, w, **kw), conv.bias, act)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(op, want)


def _subpixel_matches(z, b, act):
    """The sub-pixel instantiation against the plain interleave and the
    plain epilogue, with `_epilogue_matches`'s bar: equal for leaky_relu,
    relu and none, within 1 ulp for elu, gelu and silu. One launch, counted
    as both an epilogue and a sub-pixel one; a new channels-last tensor."""
    before = (bias_act.launches, bias_act.subpixel_launches)
    got = bias_act.bias_act_subpixel_cuda(z, b, act)
    want = bias_act.bias_act_subpixel_plain(z, b, act)
    torch.cuda.synchronize()
    assert (bias_act.launches, bias_act.subpixel_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == want.shape and got.dtype == z.dtype and got.data_ptr() != z.data_ptr()
    assert got.is_contiguous(memory_format=torch.channels_last)
    if act in EXACT_ACTS:
        assert torch.equal(got, want), act
    else:
        assert _ulps(got, want) <= 1, act


def _phases(shape, dtype, gen):
    z = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    return z.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("act", sorted(bias_act.ACTIVATIONS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,f,h,w", [
    (1, 48, 5, 7),     # odd coarse sizes, flagship-max's finest width
    (4, 64, 9, 3),     # the group batch of four
    (8, 96, 3, 11),    # a chunk of eight tiles
    (2, 20, 3, 5),     # F not a whole number of bf16 vectors: one element a load
    (1, 3, 1, 1),      # one coarse pixel, three channels
], ids=["odd-48", "n4-64", "n8-96", "f20", "tiny"])
def test_subpixel_epilogue_matches_the_plain_interleave_and_epilogue(cuda, n, f, h, w, dtype, act):
    gen = torch.Generator(device=cuda).manual_seed(23)
    z = _phases((n, 4 * f, h + 1, w + 1), dtype, gen)
    b = torch.randn((f,), generator=gen, device=cuda)
    _subpixel_matches(z, b, act)
    if dtype == torch.bfloat16:  # a bias already in the working dtype
        _subpixel_matches(z, b.to(dtype), act)


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "gelu"])
@pytest.mark.parametrize("path", list(EPILOGUE_PATHS))
def test_subpixel_epilogue_matches_at_every_resize_conv_of_the_cells(cuda, path, act):
    """The phase tensors of the four frame cells' resize-convs (the 1080p
    plane, a chunk of eight 4K tiles), bf16 channels-last, as the path
    lays them out."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    shapes = _epilogue_shapes(path)["subpixel"]
    assert len(shapes) == 3
    for shape in shapes:
        z = _phases(shape, torch.bfloat16, gen)
        _subpixel_matches(z, torch.randn((shape[1] // 4,), generator=gen, device=cuda), act)
        del z


@pytest.mark.parametrize("case", ["nchw", "misaligned"])
def test_subpixel_epilogue_refuses_what_the_kernel_does_not_take_on_the_card(cuda, case):
    shape = (2, 4 * 64, 11, 9)
    if case == "nchw":
        z, match = torch.randn(shape, device=cuda).to(torch.bfloat16), "channels-last"
    else:
        flat = torch.randn((1 + math.prod(shape),), device=cuda).to(torch.bfloat16)
        z = flat[1:].view(2, 11, 9, 4 * 64).permute(0, 3, 1, 2)
        match = "16-byte aligned"
    b = torch.randn((64,), device=cuda)
    bias_act.reset_launches()
    with pytest.raises(ValueError, match=match):
        bias_act.bias_act_subpixel(z, b, "leaky_relu")
    assert bias_act.launches == 0 and bias_act.subpixel_launches == 0


def test_subpixel_upsample_on_the_card_equals_the_resize_then_conv(cuda):
    """fp32 with TF32 off, kpn-hq's finest resize-conv (128 -> 64) over a
    batch of two odd planes: within 1e-4 x max|ref| (the model tests' bar;
    cuDNN picks its fp32 algorithm per shape) of the resize, the conv
    with its bias and the activation; the folded kernel is kept between
    calls; under grad the path launches the plain epilogue."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    up = layers.UpSample(128, 64, 3, act="leaky_relu").to(cuda)
    with torch.no_grad():
        up.ConvBlock_0.Conv_0.bias.normal_(generator=gen)
    x = torch.randn((2, 128, 37, 53), generator=gen, device=cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    conv = up.ConvBlock_0.Conv_0
    with _full_fp32(), torch.no_grad():
        bias_act.reset_launches()
        got = up(x)
        kept = up._folded[1]
        again = up(x)
        want = F.leaky_relu(F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"),
                                     conv.weight, conv.bias, padding=1), 0.2)
        torch.cuda.synchronize()
        assert (bias_act.launches, bias_act.subpixel_launches) == (2, 2)
        assert up._folded[1] is kept and torch.equal(got, again)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        bias_act.reset_launches()
    with _full_fp32():
        graded = up(x.clone().requires_grad_())
        torch.cuda.synchronize()
    assert (bias_act.launches, bias_act.subpixel_launches) == (1, 0)
    assert float((graded.detach() - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _subpixel_frame(case, fourier_1080p):
    """(a frame denoiser of a frame cell's configuration in bf16, its frame,
    its network calls a frame)."""
    frame = fourier_1080p["noisy"]
    if case == "unet-multiscale":
        d = json.loads((REPO / "h100_bench" / "configs" / "unet-multiscale.json").read_text())
        params = weights_io.load_release_params(REPO / d.pop("bench")["weights"])
        cfg = config.from_dict(config.ExperimentConfig, d)
    else:
        preset = "kpn-hq" if case == "kpn-hq-4k-tiled" else case
        cfg = config.validate_channels(config.PRESETS[preset])
        params = _release_params(preset)
    infer, (h, w), calls = cfg.infer, FRAME, 1
    if case == "kpn-hq-4k-tiled":
        infer = dataclasses.replace(infer, tile=512, tile_batch=8)
        frame, (h, w), calls = {k: _mirror_2x2(v) for k, v in frame.items()}, (2160, 3840), 5
    make, group = _maker(cfg.model)
    infer = dataclasses.replace(infer, use_pallas_ingest=group)
    den, _ = make(cfg.model, infer, h, w, params)
    return den, frame, calls


@pytest.mark.parametrize("case,subpixel,epilogues", [
    ("kpn-hq", 3, 21), ("flagship-max", 3, 21), ("kpn-hq-4k-tiled", 15, 105),
    ("tiramisu-lt1", 3, 33), ("unet-multiscale", 9, 63)])
def test_frames_of_the_cells_count_the_subpixel_epilogue(cuda, fourier_1080p, case, subpixel,
                                                        epilogues):
    """A frame of each frame cell's configuration: the resize-convs' sub-pixel
    epilogue 3 a network call (15 in the tiled 4K frame's 5 calls, 9 in the
    multi-scale frame's three backbone runs), within the epilogue's launches
    a frame, which the resize-convs leave as they were."""
    den, frame, calls = _subpixel_frame(case, fourier_1080p)
    bias_act.reset_launches()
    den(frame)
    torch.cuda.synchronize()
    assert (bias_act.subpixel_launches, bias_act.launches) == (subpixel, epilogues)
    preset = "kpn-hq" if case == "kpn-hq-4k-tiled" else case
    assert epilogues == EPILOGUES[preset] * calls


# --------------------------------------------------------------------------
# the entry points on the card: frames, the CLI, training, the tools
# --------------------------------------------------------------------------

FRAME = (1080, 1920)
GAIN_TOL_DB = 0.05  # a bf16 frame's PSNR gain against the same frame's in fp32
# the tiramisu presets round the dense stack to bf16 at every concat, which
# costs more than in the UNets; flagship-mc's output on the traced frame
# sits ~19 dB over its 4-spp input, where bf16 rounding shows
WIDE_GAIN_TOL_DB = 0.15
RELEASE = {"kpn-hq": "kpn_hq_ema_f16.npz", "flagship-hq": "flagship_hq_ema_f16.npz",
           "flagship": "flagship_ema_f16.npz", "flagship-mc": "flagship_mc_ema_f16.npz",
           "flagship-max": "kpn_ema_f16.npz", "tiramisu-lt1": "tiramisu_lt1_ema_f16.npz",
           "tiramisu-fast": "tiramisu_fast_ema_f16.npz", "tiramisu": "tiramisu_ema_f16.npz",
           "rgb-small": "rgb_small_ema_f16.npz"}
# the combined-RGB release model
RGB_SMALL = dict(backbone="unet", in_channels=10, out_channels=3, base_width=32, depth=2,
                 convs_per_level=1, act="leaky_relu", compute_dtype="bfloat16",
                 predict_residual=True)
SEQUENCE_KEYS = {"n_frames", "height", "width", "grid", "latency_ms", "latency_ms_mean",
                 "latency_ms_median", "fetch_overhead_ms", "psnr", "psnr_mean", "ssim", "ssim_mean"}


def _reset_launches():
    for op in (kpn_apply, kpn_softmax, bias_act, fused_ingest):
        op.reset_launches()


def _expect_launches(times=1, **per):
    """Each kernel launched `per` times (0 where not named) x `times` since
    _reset_launches()."""
    got = {"kpn_apply": kpn_apply.launches, "bwd_weights": kpn_apply.bwd_weights_launches,
           "bwd_noisy": kpn_apply.bwd_noisy_launches, "kpn_softmax": kpn_softmax.launches,
           "bias_act": bias_act.launches, **fused_ingest.launches}
    assert set(per) <= set(got), per
    assert got == {name: per.get(name, 0) * times for name in got}


def _frame_launches(preset, fused=False) -> dict:
    """A frame's launches through the preset's network: K1 and the softmax
    once a slot, a conv epilogue a conv, the group encode with the fused
    ingest."""
    mcfg = config.PRESETS[preset].model
    slots = mcfg.kpn_slots if mcfg.kernel_prediction else 0
    return dict(kpn_apply=slots, kpn_softmax=slots, bias_act=EPILOGUES[preset],
                group_encode=int(fused))


def _release_params(preset):
    return weights_io.load_release_params(REPO / "weights" / RELEASE[preset])


def _seeded_params(mcfg):
    return weights_io.params_from_state_dict(
        factory.init_model(mcfg, torch.Generator().manual_seed(0)).state_dict())


def _maker(mcfg):
    """(the frame factory of the model's mode, whether that is group mode)."""
    group = mcfg.out_channels == 6
    return (pipeline.make_group_frame_denoiser if group else pipeline.make_joint_frame_denoiser), group


def _gain_db(out, noisy, clean) -> float:
    """The tonemapped PSNR gain of `out` over `noisy` against `clean`."""
    tm = metrics.tonemap_for_metrics
    ref = tm(clean)
    return float(metrics.psnr(tm(out), ref) - metrics.psnr(tm(noisy), ref))


def _assert_frames_agree(got, want, tol):
    """Every pass within tol x max|ref| of the reference frame's."""
    assert set(got) == set(want)
    for name, ref in want.items():
        assert torch.isfinite(got[name]).all(), name
        rel = float((got[name] - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
        assert rel <= tol, (name, rel)


def _on_card(passes_):
    return {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in passes_.items()}


@pytest.fixture(scope="module")
def fourier_1080p():
    """The Fourier family's 1080p frame (seed 0) at 4 spp (noise seed 1):
    its passes on the host ("host_clean", "host_noisy") and on the card
    ("noisy", and "clean", the clean combined)."""
    _need_card()
    clean = synthetic.generate_clean_passes(*FRAME, seed=0)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=1)
    return {"host_clean": clean, "host_noisy": noisy, "noisy": _on_card(noisy),
            "clean": torch.as_tensor(clean["combined"], device="cuda")}


@pytest.fixture(scope="module")
def fourier_dir(fourier_1080p, tmp_path_factory):
    """The same noisy frame as a directory of EXR passes, as `denoise
    --frame` reads it."""
    path = tmp_path_factory.mktemp("frame") / "spp4_seed0"
    exr.save_frame_dir(path, fourier_1080p["host_noisy"])
    return path


@pytest.fixture(scope="module")
def traced_1080p():
    """make_scene(0) traced on the card at 1080p, the mc family of the
    headline bench: 4 spp (sample seed 4) against 1024 spp."""
    _need_card()
    gt = mc_tracer.generate_clean_passes(*FRAME, seed=0, spp=1024)
    noisy = mc_tracer.generate_noisy_passes(*FRAME, seed=0, spp=4, sample_seed=4)
    return {"gt": gt, "noisy": noisy, "clean": gt["combined"]}


def test_every_source_builds_on_the_card(cuda):
    """nvcc every csrc/*.cu and the host compiler csrc/exr_pack.cpp, all at
    once (ops/_build.py)."""
    from deepdenoiser_tpu_torch.ops import _build

    names = [*_build.sources(), "exr_pack"]
    paths = _build.build(names)
    assert sorted(paths) == sorted(names) and all(p.is_file() for p in paths.values())


# flagship-hq has no fp32 bar: its bf16 gain reads 0.126 dB under fp32's on
# this frame, where the UNets' bar is 0.05 dB (ROADMAP.md queue 1)
QUALITY = [("kpn-hq", "fourier_1080p", GAIN_TOL_DB), ("flagship-hq", "fourier_1080p", None),
           ("flagship", "fourier_1080p", GAIN_TOL_DB),
           ("flagship-max", "fourier_1080p", GAIN_TOL_DB),
           ("tiramisu-lt1", "fourier_1080p", WIDE_GAIN_TOL_DB),
           ("tiramisu-fast", "fourier_1080p", WIDE_GAIN_TOL_DB),
           ("tiramisu", "fourier_1080p", WIDE_GAIN_TOL_DB),
           ("kpn-hq", "traced_1080p", GAIN_TOL_DB), ("flagship-mc", "traced_1080p", WIDE_GAIN_TOL_DB)]


@pytest.mark.parametrize("preset,frame,tol", QUALITY,
                         ids=[f"{p}-{f.split('_')[0]}" for p, f, _ in QUALITY])
def test_bf16_frame_gains_within_its_bar_of_fp32(cuda, request, preset, frame, tol):
    """A release model's 1080p frame in bf16 through the frame factory (the
    group frame with the fused ingest): every kernel's launches, finite
    passes, a PSNR gain, and with a `tol` within `tol` dB of the same
    frame's in fp32 with TF32 off, the plain filter apply and the plain
    encode."""
    f = request.getfixturevalue(frame)
    cfg = config.validate_channels(config.PRESETS[preset])
    params = _release_params(preset)
    make, group = _maker(cfg.model)
    icfg = dataclasses.replace(cfg.infer, use_pallas_ingest=group)
    den, _ = make(cfg.model, icfg, *FRAME, params)
    _reset_launches()
    out = den(f["noisy"])
    torch.cuda.synchronize()
    _expect_launches(**_frame_launches(preset, fused=group))
    assert all(torch.isfinite(v).all() for v in out.values())
    gain = _gain_db(out["combined"], f["noisy"]["combined"], f["clean"])
    assert gain > 0
    if tol is None:
        return
    with _full_fp32():
        ref_den, _ = make(cfg.model, dataclasses.replace(icfg, compute_dtype="float32",
                                                          use_pallas_ingest=False), *FRAME, params)
        if cfg.model.kernel_prediction:
            ref_den.model.KernelPredictionHead_0.filter_apply = kpn.apply_per_pixel_kernels
        ref = ref_den(f["noisy"])["combined"]
    ref_gain = _gain_db(ref, f["noisy"]["combined"], f["clean"])
    assert abs(gain - ref_gain) <= tol, (gain, ref_gain)


CLI_DENOISE = {"kpn-hq": "joint", "flagship-hq": "joint", "flagship": "joint",
               "tiramisu-lt1": "joint", "tiramisu-fast": "joint", "tiramisu": "joint",
               "flagship-max": "group", "rgb-small": "rgb"}


@pytest.mark.parametrize("preset", list(CLI_DENOISE))
def test_cli_denoise_on_the_card(cuda, fourier_1080p, fourier_dir, tmp_path, preset):
    """`deepdenoiser-torch denoise` on the 1080p frame's EXR directory with
    the release weights: a joint model by --preset, flagship-max by a
    --config that turns the fused ingest on, the combined-RGB model by its
    --config; each kernel's launches, a finite frame and a PSNR gain."""
    from deepdenoiser_tpu_torch import cli

    mode = CLI_DENOISE[preset]
    if mode == "joint":
        source, want = ["--preset", preset], _frame_launches(preset)
    else:
        if mode == "group":
            base = config.PRESETS[preset]
            exp = dataclasses.replace(base, infer=dataclasses.replace(base.infer,
                                                                      use_pallas_ingest=True))
            want = _frame_launches(preset, fused=True)
        else:
            exp = config.ExperimentConfig(name=preset, model=factory.ModelConfig(**RGB_SMALL),
                                          data=config.DataConfig(mode="rgb"))
            want = {"bias_act": EPILOGUES[preset]}
        path = tmp_path / "config.json"
        config.save(exp, path)
        assert config.validate_channels(config.load(path)).infer.use_pallas_ingest == (mode == "group")
        source = ["--config", str(path)]
    _reset_launches()
    assert cli.main(["denoise", *source, "--weights", str(REPO / "weights" / RELEASE[preset]),
                     "--frame", str(fourier_dir), "--out", str(tmp_path / "out.exr"),
                     "--mode", mode]) == 0
    torch.cuda.synchronize()
    _expect_launches(**want)
    out = torch.from_numpy(exr.read_exr(tmp_path / "out.exr")).to(cuda)
    assert out.shape == (*FRAME, 3) and torch.isfinite(out).all()
    assert _gain_db(out, fourier_1080p["noisy"]["combined"], fourier_1080p["clean"]) > 0


def test_rgb_frame_and_denoise_crop_on_the_card(cuda, fourier_1080p):
    """The combined-RGB release model through its frame factory (10
    epilogue launches a frame) and as one unpadded crop: both gain."""
    cfg = config.validate_channels(config.ExperimentConfig(
        name="rgb-small", model=factory.ModelConfig(**RGB_SMALL), data=config.DataConfig(mode="rgb")))
    params = _release_params("rgb-small")
    noisy = fourier_1080p["noisy"]
    den, _ = pipeline.make_rgb_frame_denoiser(cfg.model, cfg.infer, *FRAME, params)
    _reset_launches()
    out = den(noisy)["combined"]
    torch.cuda.synchronize()
    _expect_launches(bias_act=EPILOGUES["rgb-small"])
    crop = pipeline.denoise_crop(cfg.model, params, noisy)
    for t in (out, crop):
        assert t.shape == (*FRAME, 3) and torch.isfinite(t).all()
        assert _gain_db(t, noisy["combined"], fourier_1080p["clean"]) > 0


@pytest.mark.parametrize("aux", [("normal", "depth", "alpha"), ("normal", "depth"), ("alpha",)],
                         ids="+".join)
def test_group_frame_with_the_fused_ingest_equals_the_plain_encode(cuda, fourier_1080p, aux):
    """The 1080p group frame in fp32 (TF32 off) with the whole-pixel encode
    against the plain stacked encode, within 1e-5 x max|ref| per pass:
    flagship-max's release weights for all aux passes; a seeded base-16
    KPN (15 epilogues a call) for the aux sets that run the depth-only and
    alpha-only bodies."""
    if len(aux) == 3:
        mcfg, epilogues = config.validate_channels(config.PRESETS["flagship-max"]).model, 21
        params = _release_params("flagship-max")
    else:
        mcfg, epilogues = factory.ModelConfig(
            in_channels=transforms.group_input_channels(aux), out_channels=6, base_width=16,
            depth=2, act="leaky_relu", kernel_prediction=True, kpn_size=3, kpn_slots=2), 15
        params = _seeded_params(mcfg)
    outs = {}
    with _full_fp32():
        for fused in (True, False):
            icfg = config.InferenceConfig(border=32, compute_dtype="float32",
                                          use_pallas_ingest=fused)
            den, _ = pipeline.make_group_frame_denoiser(mcfg, icfg, *FRAME, params, aux=aux)
            _reset_launches()
            outs[fused] = den(fourier_1080p["noisy"])
            torch.cuda.synchronize()
            _expect_launches(kpn_apply=2, kpn_softmax=2, bias_act=epilogues, group_encode=int(fused))
    _assert_frames_agree(outs[True], outs[False], 1e-5)


@pytest.mark.parametrize("aux,kernels", [
    (("normal", "depth", "alpha"), ("radiance", "normal", "depth_alpha")),
    (("normal", "depth"), ("radiance", "normal", "depth")),
    (("alpha",), ("radiance", "alpha")),
], ids=["normal+depth+alpha", "normal+depth", "alpha"])
def test_per_pass_encode_of_the_1080p_frame_is_the_one_launch_encode(cuda, fourier_1080p, aux,
                                                                    kernels):
    """The frame's four groups through encode_group_inputs_per_pass into
    one stack: a launch of each per-pass kernel a group, and the stack
    equal bit for bit to the whole-pixel encode's."""
    noisy = fourier_1080p["noisy"]
    groups = tuple(passes.LIGHT_GROUPS)
    out = torch.empty((len(groups), *FRAME, transforms.group_input_channels(aux)), device=cuda)
    _reset_launches()
    for i, g in enumerate(groups):
        fused_ingest.encode_group_inputs_per_pass(noisy, g, aux, out=out[i])
    torch.cuda.synchronize()
    _expect_launches(**{k: len(groups) for k in kernels})
    assert torch.equal(out, fused_ingest.encode_groups_fused(noisy, groups, aux))


def _mirror_2x2(x):
    """(H, W, C) -> (2H, 2W, C): the frame beside its mirror image, over
    both mirrored top to bottom."""
    top = torch.cat([x, x.flip(1)], 1)
    return torch.cat([top, top.flip(0)], 0)


@pytest.mark.parametrize("preset,scale,grid,chunks", [("kpn-hq", 2, (5, 8), 5),
                                                      ("flagship-max", 1, (3, 4), 6)],
                         ids=["kpn-hq-4k", "flagship-max-1080p"])
def test_tiled_frame_at_full_size_equals_the_whole_frame_on_the_card(cuda, fourier_1080p, preset,
                                                                    scale, grid, chunks):
    """Tiles of 512 in lazy chunks of 8, exact stitch, against the whole
    frame with the certified halo, fp32 with TF32 off: within 1e-4 x
    max|ref| per pass, each kernel once a slot and chunk. kpn-hq on the
    1080p frame mirrored 2x2 (2160x3840: 40 tiles of 656 in 5 chunks, 40
    K1 launches); flagship-max's four groups at 1080p with the fused ingest
    (48 tiles in 6 chunks), whose feathered stitch stays close to the exact
    one. In bf16 the tiled frame gains (flagship-max: feathered), kpn-hq's
    within 0.05 dB of the whole frame's gain."""
    cfg = config.validate_channels(config.PRESETS[preset])
    params = _release_params(preset)
    make, group = _maker(cfg.model)
    base = dataclasses.replace(cfg.infer, use_pallas_ingest=group)
    kinds = {"whole": dataclasses.replace(base, tile=0, border=-1),
             "exact": dataclasses.replace(base, tile=512, tile_batch=8)}
    if group:
        kinds["feather"] = dataclasses.replace(kinds["exact"], stitch="feather")
    noisy, clean = fourier_1080p["noisy"], fourier_1080p["clean"]
    if scale == 2:
        noisy, clean = {k: _mirror_2x2(v) for k, v in noisy.items()}, _mirror_2x2(clean)
    h, w = FRAME[0] * scale, FRAME[1] * scale
    slots = cfg.model.kpn_slots
    outs = {}
    with _full_fp32():
        for kind, icfg in kinds.items():
            den, g = make(cfg.model, dataclasses.replace(icfg, compute_dtype="float32"), h, w, params)
            n = 1 if kind == "whole" else chunks
            if kind != "whole":
                assert (g.rows, g.cols) == grid and g.net_size == 512 + 2 * g.halo
            _reset_launches()
            outs[kind] = den(noisy)
            torch.cuda.synchronize()
            _expect_launches(kpn_apply=slots * n, kpn_softmax=slots * n,
                             bias_act=EPILOGUES[preset] * n, group_encode=int(group))
    _assert_frames_agree(outs["exact"], outs["whole"], 1e-4)
    if group:
        for name, ref in outs["exact"].items():
            d, scale_ = (outs["feather"][name] - ref).abs(), ref.abs().max().clamp_min(1e-30)
            assert float(d.max() / scale_) <= 0.1 and float(d.mean() / scale_) <= 2e-3, name
    del outs
    gains = {}
    for kind in ("whole", "feather" if group else "exact"):
        den, _ = make(cfg.model, kinds[kind], h, w, params)
        gains[kind] = _gain_db(den(noisy)["combined"], noisy["combined"], clean)
    assert min(gains.values()) > 0, gains
    if not group:
        assert abs(gains["exact"] - gains["whole"]) <= GAIN_TOL_DB, gains


def test_multiscale_frame_on_the_card(cuda, fourier_1080p):
    """unet-multiscale at its bf16 on the benchmark's seeded weights (it has
    no release file) over a 1080p frame: its base UNet's epilogues at
    three scales, three backbone runs, and every pass within the cell
    unet-multiscale.1080p's `rel_l2` limit of the plain float32 reference
    (h100_bench/reference/multiscale.py), planed as the benchmark's frames
    driver planes it: the halo rounded to the pyramid's multiple, one band."""
    from h100_bench.reference import frame as ref_frame
    from h100_bench.reference import multiscale as ref_ms
    from h100_bench.reference import no_tf32

    bench = REPO / "h100_bench"
    d = json.loads((bench / "configs" / "unet-multiscale.json").read_text())
    weights = REPO / d.pop("bench")["weights"]
    limit = json.loads((bench / "workloads" / "unet-multiscale.1080p.json").read_text())
    cfg = config.from_dict(config.ExperimentConfig, d)
    assert cfg.model.compute_dtype == cfg.infer.compute_dtype == "bfloat16"
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, *FRAME,
                                                weights_io.load_release_params(weights))
    frame = fourier_1080p["noisy"]
    multiscale.reset_counts()
    _reset_launches()
    out = den(frame)
    torch.cuda.synchronize()
    _expect_launches(bias_act=EPILOGUES["unet-multiscale"])
    assert multiscale.backbone_calls == 3
    model, cert = d["model"], ref_ms.halo(d["model"])
    m = 2 ** model["depth"]
    halo = ref_frame.plane_halo(d["infer"], cert, m)
    p = ref_ms.to_device(ref_ms.load_params(weights), cuda)
    with no_tf32():
        want = ref_frame.denoise(lambda x: ref_ms.network(p, x, model), frame, "joint", halo,
                                 -(-cert // m) * m, m, limit["check"]["band_rows"])
    assert len(want) == 9 and out["combined"].shape == (*FRAME, 3)
    for k, r in want.items():
        gap = float((out[k].double() - r.double()).norm() / r.double().norm())
        assert gap <= limit["limits"]["rel_l2"], (k, gap)


def test_flags_frame_without_a_group_on_the_card(cuda, fourier_1080p):
    """flagship-flags (45 input channels, seeded weights) on the frame with
    its subsurface group taken out: no subsurface pass out, every other
    group's passes, and combined the recomposition of the three groups."""
    cfg = config.validate_channels(config.PRESETS["flagship-flags"])
    assert cfg.model.in_channels == 45 and cfg.data.use_flags
    den, _ = pipeline.make_joint_frame_denoiser(
        cfg.model, cfg.infer, *FRAME, _seeded_params(cfg.model), groups=tuple(cfg.data.groups),
        use_flags=True)
    out = den({k: v for k, v in fourier_1080p["noisy"].items() if not k.startswith("subsurface_")})
    present = tuple(g for g in passes.LIGHT_GROUPS if g != "subsurface")
    assert not [k for k in out if k.startswith("subsurface_")]
    assert {f"{g}_{p}" for g in present for p in ("direct", "indirect", "color")} <= set(out)
    assert all(torch.isfinite(v).all() for v in out.values())
    rec = transforms.recompose({k: v for k, v in out.items() if k != "combined"}, present)
    assert float((rec - out["combined"]).abs().max() / out["combined"].abs().max()) <= 1e-6


def test_run_sequence_on_the_card(cuda, fourier_1080p):
    """run_sequence over four noisy 1080p renders of one scene with
    flagship-hq's release weights, PSNR and SSIM on the card: a warm-up
    frame, then the frames twice (9 network calls); the report's keys,
    finite values, and the first frame better than its input in both."""
    from deepdenoiser_tpu_torch.inference import sequence

    cfg = config.validate_channels(config.PRESETS["flagship-hq"])
    clean = fourier_1080p["host_clean"]
    frames = [fourier_1080p["host_noisy"]] + [synthetic.add_mc_noise(clean, spp=4, seed=1 + i)
                                               for i in range(1, 4)]
    frames = [{k: np.asarray(v, np.float32) for k, v in f.items()} for f in frames]
    gt = np.asarray(clean["combined"], np.float32)
    _reset_launches()
    report = sequence.run_sequence(cfg.model, cfg.infer, _release_params("flagship-hq"), frames,
                                   [gt] * 4, mode="joint")
    _expect_launches(2 * 4 + 1, bias_act=EPILOGUES["flagship-hq"])
    _check_report(report, 4, FRAME)
    tm = metrics.tonemap_for_metrics
    ref = tm(fourier_1080p["clean"])[None]
    noisy = tm(fourier_1080p["noisy"]["combined"])[None]
    assert report["psnr"][0] > float(metrics.psnr_per_image(noisy, ref)[0])
    assert report["ssim"][0] > float(metrics.ssim(noisy, ref)[0])


def _check_report(report, n, hw):
    """A sequence report's keys, its frame count and size, finite values,
    SSIM in (0, 1] and a positive PSNR."""
    assert set(report) == SEQUENCE_KEYS
    assert report["n_frames"] == n and (report["height"], report["width"]) == tuple(hw)
    vals = [*report["psnr"], *report["ssim"], *report["latency_ms"], report["latency_ms_mean"]]
    assert all(math.isfinite(v) for v in vals)
    assert all(0 < v <= 1 for v in report["ssim"]) and min(report["psnr"]) > 0


# training ------------------------------------------------------------------


def test_train_step_on_the_card_matches_the_cpu_step(cuda):
    """One make_train_step step of a small joint KPN (base 16, depth 2, 8
    slots, fp32, TF32 off) on the card against the same step on the CPU
    from the same state and batch: loss and grad_norm within rel 1e-5.
    Adam's first update moves every element by about lr whatever its
    gradient, so each parameter stays within 2 lr in any case; two runs
    part by more than 1e-3 lr only where the gradient is at the level of
    the two devices' rounding (cuDNN sums in other orders), which the bar
    puts at 1e-5 of the gradient's global norm."""
    from deepdenoiser_tpu_torch.training import train as train_lib

    mcfg = factory.ModelConfig(backbone="unet", in_channels=41, out_channels=24, base_width=16,
                               depth=2, kernel_prediction=True, kpn_size=5, kpn_slots=8,
                               kpn_logit_norm=True, act="leaky_relu")
    lr = 1e-3
    tcfg = config.TrainConfig(learning_rate=lr, warmup_steps=0, schedule="constant",
                              ema_decay=0.999)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((4, 64, 64, 41), generator=gen)
    sig = torch.cat([x[..., 9 * g : 9 * g + 6] for g in range(4)], dim=-1)
    batch = {"x": x, "y": sig + 0.05 * torch.randn(sig.shape, generator=gen)}
    step = train_lib.make_train_step(mcfg, tcfg)
    with _full_fp32():
        card = train_lib.create_state(mcfg, tcfg, seed=0)
        _reset_launches()
        card, card_m = step(card, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        _expect_launches(kpn_apply=8, bwd_weights=8, kpn_softmax=8, bias_act=15)
    cpu = train_lib.create_state(mcfg, tcfg, seed=0, device="cpu")
    cpu, cpu_m = step(cpu, batch)
    for k in ("loss", "grad_norm"):
        assert float(card_m[k]) == pytest.approx(float(cpu_m[k]), rel=1e-5), k
    diffs = torch.cat([(card.params[n].detach().cpu() - p.detach()).abs().flatten()
                       for n, p in cpu.params.items()])
    grads = torch.cat([p.grad.abs().flatten() for p in cpu.params.values()])
    far = diffs > 1e-3 * lr
    assert float(diffs.max()) <= 2 * lr
    assert not far.any() or float(grads[far].max()) <= 1e-5 * float(cpu_m["grad_norm"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """kpn-hq at its training recipe's batch 16 and crop 96 (warm-up 10, lr
    2.5e-4, 8 crops a frame, one frame in five for validation), a log line
    every step, a checkpoint every 2 and an eval every 4, saved as a config
    JSON; and `synth-data` (4 Fourier frames of 192x192 at 4 and 16 spp) ->
    `prepare-data` with it."""
    _need_card()
    from deepdenoiser_tpu_torch import cli

    root = tmp_path_factory.mktemp("corpus")
    base = config.PRESETS["kpn-hq"]
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, batch_size=16, crop=96, crops_per_frame=8,
                                 validation_fraction=0.2),
        train=dataclasses.replace(base.train, learning_rate=2.5e-4, warmup_steps=10, log_every=1,
                                  checkpoint_every=2, eval_every=4))
    path = root / "train.json"
    config.save(cfg, path)
    renders, shards = root / "renders", root / "shards"
    assert cli.main(["synth-data", "--out", str(renders), "--frames", "4", "--size", "192"]) == 0
    assert cli.main(["prepare-data", "--config", str(path), "--renders", str(renders),
                     "--out", str(shards)]) == 0
    return {"cfg": cfg, "config": path, "renders": renders, "shards": shards}


def _jsonl(path):
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def _checkpoints(workdir):
    return sorted(int(p.name) for p in (workdir / "checkpoints").iterdir() if p.name.isdigit())


def _cli_denoise_checkpoint(cuda, workdir, frame_dir, out):
    """`denoise --checkpoint --ema` of a run on the 1080p frame: kpn-hq's
    launches, a finite frame."""
    from deepdenoiser_tpu_torch import cli

    _reset_launches()
    assert cli.main(["denoise", "--config", str(workdir / "config.json"), "--checkpoint",
                     str(workdir / "checkpoints"), "--ema", "--frame", str(frame_dir),
                     "--out", str(out)]) == 0
    torch.cuda.synchronize()
    _expect_launches(**_frame_launches("kpn-hq"))
    img = torch.from_numpy(exr.read_exr(out))
    assert img.shape == (*FRAME, 3) and torch.isfinite(img).all()


def test_cli_trains_resumes_denoises_and_evaluates_on_the_card(cuda, corpus, fourier_dir, tmp_path,
                                                              monkeypatch, capsys):
    """`train` 4 steps of the corpus's recipe: 8 forward, 8 d_w and no
    d_noisy launches a step, the eval's and the preview's at step 4
    counted apart; resumed to 6 (the metrics file continues, checkpoints
    2, 4, 6); `denoise --checkpoint --ema` on the 1080p frame; `eval` of
    the checkpoint over the corpus's render root."""
    from deepdenoiser_tpu_torch import cli
    from deepdenoiser_tpu_torch.data import loader
    from deepdenoiser_tpu_torch.training import loop

    in_eval = [0]

    def counted(fn):
        def run(*a, **kw):
            before = kpn_apply.launches
            try:
                return fn(*a, **kw)
            finally:
                in_eval[0] += kpn_apply.launches - before
        return run

    monkeypatch.setattr(loop, "_run_eval", counted(loop._run_eval))
    monkeypatch.setattr(loop, "_log_preview", counted(loop._log_preview))
    work = tmp_path / "run"
    argv = ["train", "--config", str(corpus["config"]), "--workdir", str(work),
            "--shards", str(corpus["shards"])]
    n_val = loader.make_dataset(corpus["shards"] / "validation", corpus["cfg"].data,
                                training=False).batches_per_epoch
    evals = 2 * n_val + 1  # the parameters and the EMA over each batch, and the preview
    _reset_launches()
    assert cli.main([*argv, "--steps", "4"]) == 0
    torch.cuda.synchronize()
    assert in_eval[0] == 8 * evals
    _expect_launches(kpn_apply=8 * (4 + evals), bwd_weights=8 * 4, kpn_softmax=8 * (4 + evals),
                     bias_act=EPILOGUES["kpn-hq"] * (4 + evals))
    recs = _jsonl(work / "metrics_train.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3, 4] and all(math.isfinite(r["loss"]) for r in recs)
    assert [r["step"] for r in _jsonl(work / "metrics_eval.jsonl")] == [4]
    assert (work / "previews" / "step_00000004.png").is_file()

    _reset_launches()
    assert cli.main([*argv, "--steps", "6"]) == 0
    torch.cuda.synchronize()
    _expect_launches(2, kpn_apply=8, bwd_weights=8, kpn_softmax=8, bias_act=EPILOGUES["kpn-hq"])
    assert [r["step"] for r in _jsonl(work / "metrics_train.jsonl")] == list(range(1, 7))
    assert _checkpoints(work) == [2, 4, 6]

    _cli_denoise_checkpoint(cuda, work, fourier_dir, tmp_path / "out.exr")
    capsys.readouterr()
    assert cli.main(["eval", "--config", str(work / "config.json"), "--checkpoint",
                     str(work / "checkpoints"), "--renders", str(corpus["renders"])]) == 0
    out = capsys.readouterr().out
    _check_report(json.loads(out[out.index("{"):]), 4, (192, 192))


@pytest.mark.parametrize("preset,dtype,feed,steps", [
    ("kpn-hq", "bfloat16", "corpus", 100), ("flagship-hq", "bfloat16", "corpus", 30),
    ("flagship-hq", "float32", "corpus", 30), ("kpn-hq", "bfloat16", "mixed-mc", 10),
], ids=["kpn-hq-one-batch", "flagship-hq-one-batch", "flagship-hq-fp32-one-batch",
        "kpn-hq-device-batches"])
def test_make_train_step_on_the_card(cuda, corpus, preset, dtype, feed, steps):
    """make_train_step at the recipe's batch and crop: K1 and its d_w once a
    slot a step for kpn-hq, an epilogue a conv forward, finite losses. On
    one fixed batch of the corpus at lr 1e-3 (constant): kpn-hq's loss
    halves in 100 steps; flagship-hq, which diverges at that lr, runs 30,
    in bf16 and in fp32 with TF32 off. On a new mixed-mc batch made on the
    card each step (data/synthetic_device.py), at the recipe's own lr."""
    from deepdenoiser_tpu_torch.data import loader
    from deepdenoiser_tpu_torch.training import train as train_lib

    mcfg = dataclasses.replace(config.validate_channels(config.PRESETS[preset]).model,
                               compute_dtype=dtype)
    tcfg = corpus["cfg"].train
    if feed == "corpus":
        tcfg = dataclasses.replace(tcfg, learning_rate=1e-3, warmup_steps=0, schedule="constant")
        dcfg = corpus["cfg"].data
        raw = loader.make_dataset(corpus["shards"] / "train", dcfg, training=False)[(0, 0)]
        batch = loader.make_batch_encoder(dcfg)({k: v.to(cuda) for k, v in raw.items()})
        batches = itertools.repeat(batch, steps)
    else:
        gen = torch.Generator(device=cuda).manual_seed(0)
        batches = (synthetic_device.training_batch(gen, 16, 96, "joint", feed) for _ in range(steps))
    state = train_lib.create_state(mcfg, tcfg, seed=0)
    step = train_lib.make_train_step(mcfg, tcfg)
    k1 = mcfg.kpn_slots if mcfg.kernel_prediction else 0
    losses = []
    with _full_fp32() if dtype == "float32" else contextlib.nullcontext():
        _reset_launches()
        for b in batches:
            state, mets = step(state, b)
            losses.append(float(mets["loss"]))
    _expect_launches(steps, kpn_apply=k1, bwd_weights=k1, kpn_softmax=k1, bias_act=EPILOGUES[preset])
    assert all(math.isfinite(v) for v in losses), losses
    if preset == "kpn-hq" and feed == "corpus":
        assert losses[-1] < 0.5 * losses[0], losses


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_under_torch_distributed_run_on_the_card(cuda, corpus, fourier_dir, tmp_path):
    """`train` under torch.distributed.run, two ranks sharing the card over
    gloo, 4 steps of the corpus's recipe: rank 0 reports the group, the
    metrics file holds every step with a finite loss, the last checkpoint
    is step 4; one process then denoises the 1080p frame from it."""
    import os
    import signal
    import subprocess
    import sys

    work = tmp_path / "run"
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
            "2", "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
            "-m", "deepdenoiser_tpu_torch.cli", "train", "--config", str(corpus["config"]),
            "--workdir", str(work), "--shards", str(corpus["shards"]), "--steps", "4"]
    # a session of its own, so a timeout stops the launcher and its ranks together
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, (stdout + stderr)[-3000:]
    assert any(ln.startswith("[dist]") for ln in stdout.splitlines()), stdout[-3000:]
    recs = _jsonl(work / "metrics_train.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3, 4] and all(math.isfinite(r["loss"]) for r in recs)
    assert _checkpoints(work)[-1] == 4
    _cli_denoise_checkpoint(cuda, work, fourier_dir, tmp_path / "out.exr")


def test_batch_frame_denoiser_on_a_4_way_mesh_of_one_card(cuda, fourier_1080p):
    """Four noisy 1080p renders of one scene through
    make_batch_frame_denoiser on the data mesh ["cuda:0"] * 4, kpn-hq in
    bf16: a frame's launches four times, and each frame within 1e-4 x
    max|ref| of its own one-frame denoise."""
    from deepdenoiser_tpu_torch.inference import sequence
    from deepdenoiser_tpu_torch.parallel import mesh

    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = _release_params("kpn-hq")
    clean = fourier_1080p["host_clean"]
    frames = [fourier_1080p["noisy"]] + [_on_card(synthetic.add_mc_noise(clean, spp=4, seed=2 + i))
                                         for i in range(3)]
    batch = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    bden, _ = sequence.make_batch_frame_denoiser(
        cfg.model, cfg.infer, mesh.make_mesh(4, "data", devices=["cuda:0"] * 4), *FRAME, params)
    one, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, *FRAME, params)
    _reset_launches()
    got = bden(batch)
    torch.cuda.synchronize()
    _expect_launches(4, **_frame_launches("kpn-hq"))
    assert got.shape == (4, *FRAME, 3)
    for i, f in enumerate(frames):
        _assert_frames_agree({"combined": got[i]}, {"combined": one(f)["combined"]}, 1e-4)


@pytest.mark.parametrize("preset,bands", [("kpn-hq", 2), ("kpn-hq", 4), ("flagship-max", 4)],
                         ids=["kpn-hq-2", "kpn-hq-4", "flagship-max-4"])
def test_banded_1080p_frame_on_one_card_equals_the_whole_frame(cuda, fourier_1080p, preset, bands):
    """The 1080p frame in row bands on the spatial mesh ["cuda:0"] * bands
    (flagship-max with the fused ingest), fp32 with TF32 off: within 1e-4 x
    max|ref| per pass of the whole frame with the certified halo, the
    network's kernels once a band, the group encode once a frame. In bf16
    the banded frame gains, kpn-hq's within 0.05 dB of its fp32 gain."""
    from deepdenoiser_tpu_torch.parallel import mesh

    cfg = config.validate_channels(config.PRESETS[preset])
    params = _release_params(preset)
    make, group = _maker(cfg.model)
    icfg = dataclasses.replace(cfg.infer, spatial_shard=True, use_pallas_ingest=group)
    spatial = mesh.make_mesh(bands, "spatial", devices=["cuda:0"] * bands)
    want = {k: v * (1 if k == "group_encode" else bands)
            for k, v in _frame_launches(preset, fused=group).items()}
    noisy, clean = fourier_1080p["noisy"], fourier_1080p["clean"]
    with _full_fp32():
        icfg32 = dataclasses.replace(icfg, compute_dtype="float32")
        banded, _ = make(cfg.model, icfg32, *FRAME, params, mesh=spatial)
        _reset_launches()
        got = banded(noisy)
        torch.cuda.synchronize()
        _expect_launches(**want)
        ref = make(cfg.model, icfg32, *FRAME, params)[0](noisy)
    _assert_frames_agree(got, ref, 1e-4)
    den, _ = make(cfg.model, icfg, *FRAME, params, mesh=spatial)
    _reset_launches()
    out = den(noisy)
    torch.cuda.synchronize()
    _expect_launches(**want)
    gain = _gain_db(out["combined"], noisy["combined"], clean)
    assert gain > 0
    if not group:
        assert abs(gain - _gain_db(got["combined"], noisy["combined"], clean)) <= GAIN_TOL_DB


def test_release_export_of_a_recipe_run_denoises_through_the_cli(cuda, fourier_1080p, fourier_dir,
                                                                tmp_path):
    """kpn-hq through the recipe without a teacher, from its release npz (2
    steps at crop 32, a validation at step 2): 8 K1 and 8 d_w launches a
    step, 8 K1 a validation batch; the -best checkpoint's extra names the
    model; tools/export_release_weights.py writes the release file's keys,
    shapes and dtypes; `denoise --weights` with it gains on the 1080p
    frame."""
    from deepdenoiser_tpu_torch import cli
    from deepdenoiser_tpu_torch.tools import export_release_weights, pretrain_flagship
    from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager

    out = tmp_path / "run"
    _reset_launches()
    assert pretrain_flagship.main([
        "--model", "kpn-hq", "--crop", "32", "--batch", "2", "--steps", "2", "--val-every", "2",
        "--log-every", "1", "--out", str(out),
        "--init-from", str(REPO / "weights" / RELEASE["kpn-hq"])]) == 0
    torch.cuda.synchronize()
    forwards = 2 + pretrain_flagship.VAL_BATCHES
    _expect_launches(kpn_apply=8 * forwards, bwd_weights=8 * 2, kpn_softmax=8 * forwards,
                     bias_act=EPILOGUES["kpn-hq"] * forwards)
    _, extra = CheckpointManager(f"{out}-best").read_latest(map_location="cpu")
    assert set(extra) == {"model", "mode", "val_psnr", "family"}
    assert (extra["model"], extra["mode"]) == ("kpn-hq", "joint")
    npz = tmp_path / "kpn_hq_best_f16.npz"
    assert export_release_weights.main(["--ckpt", f"{out}-best", "--out", str(npz),
                                        "--model", "kpn-hq"]) == 0
    with np.load(npz) as a, np.load(REPO / "weights" / RELEASE["kpn-hq"]) as b:
        assert {k: (a[k].shape, a[k].dtype) for k in a.files} == \
            {k: (b[k].shape, b[k].dtype) for k in b.files}
    _reset_launches()
    assert cli.main(["denoise", "--preset", "kpn-hq", "--weights", str(npz), "--frame",
                     str(fourier_dir), "--out", str(tmp_path / "out.exr")]) == 0
    torch.cuda.synchronize()
    _expect_launches(**_frame_launches("kpn-hq"))
    img = torch.from_numpy(exr.read_exr(tmp_path / "out.exr")).to(cuda)
    assert _gain_db(img, fourier_1080p["noisy"]["combined"], fourier_1080p["clean"]) > 0


# the traced frame ----------------------------------------------------------


def test_traced_1080p_frame_recomposes_on_the_card(cuda, traced_1080p):
    """The traced frame at 1024 and at 4 spp: finite 1080p passes, and
    combined the recomposition of the groups within 2e-5."""
    for f in (traced_1080p["gt"], traced_1080p["noisy"]):
        assert f["combined"].shape == (*FRAME, 3)
        assert all(torch.isfinite(v).all() for v in f.values())
        assert float((f["combined"] - transforms.recompose(f)).abs().max()) <= 2e-5


@pytest.mark.parametrize("seed", [0, 5])
def test_tracer_estimates_on_the_card_are_within_monte_carlo_error_of_the_cpu(cuda, seed):
    """make_scene(seed) at 96x128 and 64 spp (scene 0 has emitters, 5
    none): the deterministic buffers under the flip bar, and the direct
    and indirect estimates on the card within 1.5x the RMS spread of two
    independent CPU estimates (draw seeds 1 and 2) of each other."""
    renders = {}
    for name, dev, key in (("card", cuda, 1), ("cpu", "cpu", 1), ("cpu2", "cpu", 2)):
        out = mc_tracer.render(mc_tracer.make_scene(seed, device=dev), 96, 128, 64,
                               seeded(key, dev))
        renders[name] = {k: v.cpu() for k, v in out.items()}
    card, cpu, cpu2 = renders["card"], renders["cpu"], renders["cpu2"]
    torch_flips.assert_flips_only({k: v.numpy() for k, v in card.items()},
                                  {k: v.numpy() for k, v in cpu.items()})

    def rms(a, b):
        return float((a - b).pow(2).mean().sqrt())

    for p in ("diffuse_direct", "diffuse_indirect"):
        spread = rms(cpu[p], cpu2[p])
        assert max(rms(card[p], c[p]) for c in (cpu, cpu2)) <= 1.5 * spread, p


# the tools -----------------------------------------------------------------


def _count_frames(monkeypatch) -> list:
    """A list that gets one [frames, K1 launches] record per joint or group
    frame denoiser called from now on, in the order of their first calls."""
    records = []

    def counted(call):
        def run(self, pass_dict):
            if "_counted" not in self.__dict__:
                self._counted = [0, 0]
                records.append(self._counted)
            before = kpn_apply.launches
            out = call(self, pass_dict)
            self._counted[0] += 1
            self._counted[1] += kpn_apply.launches - before
            return out
        return run

    for cls in (pipeline.JointFrameDenoiser, pipeline.GroupFrameDenoiser):
        monkeypatch.setattr(cls, "__call__", counted(cls.__call__))
    return records


def _expect_frame_launches(records, k1_per_frame, epilogues_per_frame, **per_frame):
    """Each frame denoiser's K1 launches a frame (one entry a denoiser, in
    order), and every kernel's launches in all: the softmax beside each K1
    launch, the epilogues of every denoiser's frames, the others named a
    frame."""
    assert len(records) == len(k1_per_frame), records
    assert all(n >= 1 and k == want * n for (n, k), want in zip(records, k1_per_frame)), records
    frames = sum(n for n, _ in records)
    k1 = sum(k for _, k in records)
    _expect_launches(kpn_apply=k1, kpn_softmax=k1,
                     bias_act=sum(n * e for (n, _), e in zip(records, epilogues_per_frame)),
                     **{k: v * frames for k, v in per_frame.items()})


def _run_tool(monkeypatch, capsys, name, argv) -> tuple:
    """tools/<name>.main(argv) in-process on the card: (its last JSON line,
    the frame denoisers' records, its stdout)."""
    import importlib

    module = importlib.import_module(f"deepdenoiser_tpu_torch.tools.{name}")
    records = _count_frames(monkeypatch)
    capsys.readouterr()
    _reset_launches()
    assert module.main(argv) == 0
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("{") and ln.endswith("}")]
    return (json.loads(lines[-1]) if lines else None), records, out


def _gains_positive(row):
    assert all(v > 0 for k, v in row.items() if "gain" in k), row


SMALL = ["--height", "540", "--width", "960"]


@pytest.mark.parametrize("model,k1", [("kpn-hq", 8), ("kpn", 2)])
def test_bench_model_on_the_card(cuda, monkeypatch, capsys, model, k1):
    rec, records, _ = _run_tool(monkeypatch, capsys, "bench_model",
                                ["--model", model, *SMALL, "--chain", "2", "--samples", "2"])
    _expect_frame_launches(records, [k1], [EPILOGUES[model]])
    assert rec["model"] == model and rec["latency_ms"] > 0 and len(rec["samples_ms"]) == 2
    _gains_positive(rec)


@pytest.mark.parametrize("tiling,k1", [([], 8), (["--tile", "256", "--tile-batch", "8"], 16)],
                         ids=["whole", "tiled"])
def test_bench_4k_on_the_card(cuda, monkeypatch, capsys, tiling, k1):
    """kpn-hq over 2 frames of 540x960, whole or in 12 tiles of 256 in two
    chunks of 8 (one network call a chunk)."""
    rec, records, _ = _run_tool(monkeypatch, capsys, "bench_4k",
                                ["--model", "kpn-hq", "--frames", "2", *SMALL, *tiling])
    _expect_frame_launches(records, [k1], [EPILOGUES["kpn-hq"] * k1 // 8])
    assert rec["psnr_mean"] > rec["psnr_noisy_mean"] and len(rec["latency_ms"]) == 2
    assert rec["resolution"] == "960x540"


def test_bench_sequence_on_the_card(cuda, monkeypatch, capsys):
    rec, records, _ = _run_tool(monkeypatch, capsys, "bench_sequence", [
        "--model", "kpn-hq", "--weights", str(REPO / "weights" / RELEASE["kpn-hq"]),
        "--frames", "4", *SMALL])
    _expect_frame_launches(records, [8], [EPILOGUES["kpn-hq"]])
    assert rec["gain_db_mean"] > 0 and len(rec["frames"]) == 4


def test_bench_input_pipeline_on_the_card(cuda, monkeypatch, capsys, tmp_path):
    """Its two timed paths, each after a warm-up step: 8 K1 and 8 d_w a
    step, every rate finite and positive."""
    from deepdenoiser_tpu_torch.tools import bench_input_pipeline

    shards = bench_input_pipeline._build_corpus(tmp_path, 32)
    rec, records, _ = _run_tool(monkeypatch, capsys, "bench_input_pipeline", [
        "--model", "kpn-hq", "--batch", "2", "--crop", "32", "--steps", "3",
        "--shards", str(shards)])
    assert records == []
    _expect_launches(2 * (3 + 1), kpn_apply=8, bwd_weights=8, kpn_softmax=8,
                     bias_act=EPILOGUES["kpn-hq"])
    for key in ("host_iter_batches_per_s", "grain_2dispatch_steps_per_s",
                "synth_fused_steps_per_s", "grain_vs_synth"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key


def test_eval_holdout_on_the_card(cuda, monkeypatch, capsys):
    """flagship on its four families at 540x960, one frame at 4 spp."""
    rec, records, _ = _run_tool(monkeypatch, capsys, "eval_holdout",
                                [*SMALL, "--frames", "1", "--spp", "4"])
    _expect_frame_launches(records, [0] * 4, [EPILOGUES["flagship"]] * 4)
    for row in rec["eval_holdout"]:
        _gains_positive(row)


def test_eval_zoo_on_the_card(cuda, monkeypatch, capsys):
    """kpn-hq, flagship-hq and kpn (group) at 540x960, the traced family
    among the columns."""
    models = (("kpn-hq", 8), ("flagship-hq", 0), ("kpn", 2))
    rec, records, _ = _run_tool(monkeypatch, capsys, "eval_zoo",
                                ["--models", *(m for m, _ in models), *SMALL, "--frames", "1"])
    _expect_frame_launches(records, [k for _, k in models], [EPILOGUES[m] for m, _ in models])
    assert [r["model"] for r in rec["zoo"]] == [m for m, _ in models]
    for row in rec["zoo"]:
        _gains_positive(row)
        assert row["latency_ms"] is not None and "mc_gain_db" in row


def test_profile_tool_on_the_card(cuda, monkeypatch, capsys, tmp_path):
    """A Chrome trace of two flagship frames, each its own span."""
    _, records, _ = _run_tool(monkeypatch, capsys, "profile", [
        "--iters", "2", "--out", str(tmp_path), "--height", "270", "--width", "480"])
    _expect_frame_launches(records, [0], [EPILOGUES["flagship"]])
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"frame_0", "frame_1"} <= names


def test_diag_multiscale_on_the_card(cuda, monkeypatch, capsys):
    """On seeded weights (the repo ships none): its base UNet at three, two
    and one scales, finite rows."""
    from deepdenoiser_tpu_torch.tools import eval_zoo
    from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS

    params = _seeded_params(MODELS["multiscale"])
    monkeypatch.setattr(eval_zoo, "load_model_params",
                        lambda name: (MODELS[name], params, "joint"))
    rec, records, _ = _run_tool(monkeypatch, capsys, "diag_multiscale",
                                ["--frames", "1", "--height", "256", "--width", "384"])
    per_scale = EPILOGUES["unet-multiscale"] // 3
    _expect_frame_launches(records, [0] * 3, [per_scale * n for n in (3, 2, 1)])
    rows = rec["multiscale_diag"]
    assert [r["n_scales"] for r in rows] == [3, 2, 1]
    assert all(math.isfinite(v) for r in rows for v in r.values())


@pytest.mark.parametrize("name", ["sweep_bench", "sweep_joint"])
def test_sweep_measure_on_the_card(cuda, monkeypatch, name):
    """measure() of each sweep's first config (s2d stem, depth 3, 14
    epilogues a frame) at 270x480: two warm-up frames, then K x SAMPLES."""
    import importlib

    from deepdenoiser_tpu_torch.tools import sweep_bench

    module = importlib.import_module(f"deepdenoiser_tpu_torch.tools.{name}")
    monkeypatch.setattr(module, "H", 270)
    monkeypatch.setattr(module, "W", 480)
    frame = sweep_bench.bench_frame(270, 480, cuda)
    first = module.CONFIGS[0]
    _reset_launches()
    ms = module.measure(*first, frame) if name == "sweep_bench" else module.measure(first, frame)
    torch.cuda.synchronize()
    _expect_launches(2 + module.K * module.SAMPLES, bias_act=14)
    assert math.isfinite(ms) and ms > 0


@pytest.mark.parametrize("model", ["flagship-hq", "flagship"])
def test_roofline_of_the_unet_presets_on_the_card(cuda, monkeypatch, capsys, model):
    """As kpn-hq's above, for the two plain UNets: no K1 launch."""
    _, records, out = _run_tool(monkeypatch, capsys, "roofline",
                                ["--model", model, "--border", "32", "--chain", "2"])
    assert all(k == 0 for _, k in records) and records
    rep = json.loads(out[out.index("{"):])
    assert 0 < rep["mfu"] <= 1 and 0 < rep["hbm_utilization"] <= 1.05
    assert rep["device"] == torch.cuda.get_device_name(0) and rep["weights"] == "release"


def test_traffic_breakdown_of_a_kpn_hq_frame_on_the_card(cuda, monkeypatch, capsys, tmp_path):
    """--time: the stages' times, and K1's row of the op table holding the
    frame's 8 launches."""
    import re

    _, _, out = _run_tool(monkeypatch, capsys, "traffic_breakdown", [
        "--model", "kpn-hq", "--border", "32", "--time", "--out", str(tmp_path / "report.txt")])
    lines = out.splitlines()
    rows = [m for ln in lines if (m := re.match(r"\s*kpn_apply\s.*\sx(\d+)\s*$", ln))]
    assert len(rows) == 1 and int(rows[0].group(1)) == 8
    assert kpn_apply.launches >= 8 and kpn_apply.launches % 8 == 0
    stages = {m.group(1) for ln in lines
              if (m := re.match(r"\s+(encode|net|decode\+recompose|FULL pipeline|sum of stages)"
                                r"\s+[\d.]+ ms", ln))}
    assert len(stages) == 5, stages


@pytest.fixture(scope="module")
def bench_frames():
    """The headline bench's four families at 1080p on the card."""
    _need_card()
    from deepdenoiser_tpu_torch.tools import bench

    return bench.build_frames(*FRAME, 1024, torch.device("cuda"))


@pytest.mark.parametrize("argv,models,k1", [
    ([], ("flagship-hq", "flagship", "flagship-mc"), [0, 0, 0]),
    (["--model", "kpn-hq"], ("kpn-hq", "flagship", "flagship-mc"), [8, 0, 0]),
], ids=["defaults", "kpn-hq"])
def test_headline_bench_record_on_the_card(cuda, monkeypatch, bench_frames, argv, models, k1):
    """tools/bench on its 1080p families: the record's contract (value the
    headline's fps, vs_baseline fps / 10), each endpoint's keys, a gain on
    every family (the Gaussian-trained s2d flagship's on the traced one
    only finite: it loses there in the JAX package's record too)."""
    from deepdenoiser_tpu_torch.tools import bench

    records = _count_frames(monkeypatch)
    _reset_launches()
    rec = bench.run(bench.parse_args(argv), bench_frames)
    torch.cuda.synchronize()
    _expect_frame_launches(records, k1, [EPILOGUES[m] for m in models])
    assert {"metric", "value", "unit", "vs_baseline", "status", "headline", "speed", "mc"} <= set(rec)
    assert (rec["metric"], rec["unit"], rec["status"]) == (
        "1080p_full_multipass_denoise_throughput", "frames/sec/chip", "ok")
    assert rec["value"] == rec["headline"]["fps"]
    assert rec["vs_baseline"] == round(rec["headline"]["fps"] / 10, 3)
    families = ("fourier", "holdout", "holdout2", "mc")
    for key, model in zip(("headline", "speed", "mc"), models):
        obj = rec[key]
        assert set(obj) == {"model", "ms", "fps", "weights",
                            *(f"{m}_{f}" for f in families for m in ("db", "ssim"))}
        assert (obj["model"], obj["weights"]) == (model, "release")
        assert obj["ms"] > 0 and obj["fps"] > 0
        for f in families:
            gain = obj[f"db_{f}"]
            assert math.isfinite(gain) if (model, f) == ("flagship", "mc") else gain > 0, (key, f)


# --------------------------------------------------------------------------
# The KPCN (models/kpcn.py): KS and K1 at k = 21, KB at its widths, and the
# tensors over 2**31 elements that its 1080p group plane makes.

KPCN_PLANE = (4, 1136, 1976)  # kpcn.1080p's network batch: 4 groups, border 28


def _kpcn_config():
    d = json.loads((REPO / "h100_bench" / "configs" / "kpcn.json").read_text())
    bench = d.pop("bench")
    return d, REPO / bench["weights"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lead,crop", [((2, 17, 23), False), ((4, 33, 70), True), ((1, 1, 3), False)])
def test_kpn_softmax_kernel_at_441_taps_matches_plain_version(cuda, dtype, lead, crop):
    """The warp form: both slot views of an (N,H,W,882) output in fp32 and
    bf16 (read in place), ragged pixel counts, a cropped view; with and
    without the norm."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    feats = (3 * torch.randn((*lead, 882), generator=gen, device=cuda)).to(dtype)
    if crop:
        feats = feats[:, 2:-1, 1:-3, :]
    kpn_softmax.reset_launches()
    for s, tau in itertools.product(range(2), (None, torch.tensor(3.0, device=cuda))):
        logits = feats[..., 441 * s: 441 * (s + 1)]
        got = kpn_softmax.KpnSoftmax.apply(logits, tau)
        want = kpn_softmax.softmax_plain(logits.float(), tau)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == want.shape
        # the same fp32 operations, sums in another order; exp carries z's rounding
        assert bool(torch.all((got - want).abs() <= 1e-6 + 1e-4 * want.abs()))
    assert kpn_softmax.launches == 4


@pytest.mark.parametrize("n,h,w,c", [(2, 19, 45, 3), (4, 40, 70, 3), (1, 1, 3, 1), (3, 9, 33, 4)])
def test_kpn_apply_kernel_at_k21_matches_plain_version(cuda, n, h, w, c):
    """The warp form against kpn.apply_per_pixel_kernels: contiguous
    weights, a slot view of the signal (the group input's first 6 of 14
    channels), ragged tiles, a frame smaller than the filter."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    x = torch.rand((n, h, w, 14), generator=gen, device=cuda)
    noisy = x[..., 3: 3 + c]
    weights = torch.softmax(2 * torch.randn((n, h, w, 441), generator=gen, device=cuda), dim=-1)
    kpn_apply.reset_launches()
    got = kpn_apply.apply_per_pixel_kernels(noisy, weights, 21)
    want = kpn.apply_per_pixel_kernels(noisy, weights, 21)
    torch.cuda.synchronize()
    assert kpn_apply.launches == 1 and got.shape == (n, h, w, c) and got.is_contiguous()
    # the same products, summed as 32 lanes' partial sums and a butterfly
    assert _within(got, want)
    # strided weights (a planar view) take the same form through their strides
    planar = weights.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    torch.testing.assert_close(kpn_apply.apply_cuda(noisy, planar, 21), got, rtol=0, atol=0)


def test_kpn_apply_backward_at_k21_is_refused_on_the_card(cuda):
    noisy = torch.rand((1, 8, 8, 3), device=cuda, requires_grad=True)
    weights = torch.softmax(torch.randn((1, 8, 8, 441), device=cuda), -1).requires_grad_()
    out = kpn_apply.apply_per_pixel_kernels(noisy, weights, 21)
    with pytest.raises(ValueError, match="kernel_size 21 .*no backward kernel"):
        out.sum().backward()


@pytest.mark.parametrize("c", [100, 882])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_bias_act_kernel_at_the_kpcn_widths_is_the_plain_chain(cuda, c, act):
    gen = torch.Generator(device=cuda).manual_seed(c)
    z = torch.randn((4, c, 37, 53), generator=gen, device=cuda).to(torch.bfloat16)
    z = z.contiguous(memory_format=torch.channels_last)
    b = torch.randn((c,), generator=gen, device=cuda)
    want = bias_act.bias_act_plain(z, b, act)
    bias_act.reset_launches()
    got = bias_act.bias_act(z.clone(), b, act)
    torch.cuda.synchronize()
    assert bias_act.launches == 1 and torch.equal(got, want)


def _big_rows(n_rows):
    """(image, row) bands of the KPCN plane whose channels-last elements
    cross 2**31 and 2**32 at 882 channels, and the plane's last rows."""
    n, h, w = KPCN_PLANE
    bands = []
    for at in (2**31, 2**32):
        px = at // 882
        img, y = px // (h * w), px % (h * w) // w
        bands.append((img, max(10, y - n_rows // 2)))
    bands.append((n - 1, h - 10 - n_rows))
    return bands


def test_bias_act_kernel_over_2_31_elements(cuda):
    """The wide instantiation on the KPCN's (4, 882, 1136, 1976) logits, in
    place, against the plain chain on bands around the 2**31 and 2**32
    element offsets and at the end (bit for bit: relu and none are)."""
    n, h, w = KPCN_PLANE
    gen = torch.Generator(device=cuda).manual_seed(31)
    z = torch.empty((n, 882, h, w), dtype=torch.bfloat16, device=cuda,
                    memory_format=torch.channels_last)
    z.normal_(generator=gen)
    assert z.numel() > 2**32
    b = torch.randn((882,), generator=gen, device=cuda)
    bands = _big_rows(4)
    before = [z[i, :, y: y + 4].clone() for i, y in bands]
    bias_act.reset_launches()
    out = bias_act.bias_act(z, b, "relu")
    torch.cuda.synchronize()
    assert out is z and bias_act.launches == 1
    for (i, y), zb in zip(bands, before):
        assert torch.equal(z[i, :, y: y + 4], bias_act.bias_act_plain(zb[None], b, "relu")[0])
    del z, out
    planar = torch.empty((n, 882, h, w), dtype=torch.bfloat16, device=cuda).normal_(generator=gen)
    before = [planar[i, :, y: y + 4].clone() for i, y in bands]
    bias_act.bias_act(planar, b, "none")
    torch.cuda.synchronize()
    for (i, y), zb in zip(bands, before):
        assert torch.equal(planar[i, :, y: y + 4], bias_act.bias_act_plain(zb[None], b, "none")[0])
    del planar
    torch.cuda.empty_cache()


def test_kpn_softmax_and_apply_over_2_31_elements(cuda):
    """KS on slot 1 of the KPCN's bf16 (4, 1136, 1976, 882) logits, 3.96e9
    weights out, then K1 at k = 21 over them: both against the plain
    versions on bands around the 2**31 and 2**32 element offsets of the
    weights and at the end (K1's plain version on the band with 10 rows of
    context)."""
    n, h, w = KPCN_PLANE
    gen = torch.Generator(device=cuda).manual_seed(32)
    feats = torch.empty((n, h, w, 882), dtype=torch.bfloat16, device=cuda)
    feats.normal_(generator=gen).mul_(3)
    logits = feats[..., 441:]
    weights = kpn_softmax.KpnSoftmax.apply(logits, None)
    assert weights.numel() > 2**31
    x = torch.rand((n, h, w, 14), generator=gen, device=cuda)
    noisy = x[..., 3:6]
    out = kpn_apply.apply_per_pixel_kernels(noisy, weights, 21)
    torch.cuda.synchronize()
    for i, y in [(p // (h * w), p % (h * w) // w) for p in (2**31 // 441, 2**32 // 441)] + [
            (n - 1, h - 14)]:
        y = min(max(y - 2, 10), h - 14)
        want_w = kpn_softmax.softmax_plain(logits[i: i + 1, y: y + 4].float(), None)
        got_w = weights[i: i + 1, y: y + 4]
        assert bool(torch.all((got_w - want_w).abs() <= 1e-6 + 1e-4 * want_w.abs()))
        lo = y - 10
        want = kpn.apply_per_pixel_kernels(noisy[i: i + 1, lo: y + 14],
                                           weights[i: i + 1, lo: y + 14], 21)[:, 10:14]
        assert _within(out[i: i + 1, y: y + 4], want)
    del feats, logits, weights, out
    torch.cuda.empty_cache()


def test_kpcn_frame_on_the_card_against_the_reference(cuda, fourier_1080p):
    """kpcn at its bf16 on the benchmark's seeded weights over a 1080p frame,
    with the fused group encode: one network call over the four groups'
    (4, 1136, 1976) plane, 9 conv epilogues, 2 softmax and 2 K1 launches,
    15.84 GB of bf16 logits read, a peak under 40 GiB, and every pass
    within the cell kpcn.1080p's `rel_l2` limit of the plain float32
    reference (h100_bench/reference/kpcn.py) in bands of the cell's rows."""
    from h100_bench.reference import frame as ref_frame
    from h100_bench.reference import kpcn as ref_kpcn
    from h100_bench.reference import no_tf32

    d, weights = _kpcn_config()
    cell = json.loads((REPO / "h100_bench" / "workloads" / "kpcn.1080p.json").read_text())
    cfg = config.from_dict(config.ExperimentConfig, d)
    infer = dataclasses.replace(cfg.infer, use_pallas_ingest=True)
    den, grid = pipeline.make_group_frame_denoiser(cfg.model, infer, *FRAME,
                                                   weights_io.load_release_params(weights))
    assert (grid.tile_h + 2 * grid.halo, grid.tile_w + 2 * grid.halo) == KPCN_PLANE[1:]
    frame = fourier_1080p["noisy"]
    den(frame)  # warm-up: builds and plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    tiled.reset_net_calls()
    kpn.reset_counts()
    out = den(frame)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    _expect_launches(kpn_apply=2, kpn_softmax=2, bias_act=9, group_encode=1)
    assert tiled.net_calls == 1
    assert kpn.logit_bytes == 2 * 4 * 1136 * 1976 * 441 * 2
    assert peak < 40 * 2**30, peak / 2**30
    model, cert = d["model"], ref_kpcn.halo(d["model"])
    halo = ref_frame.plane_halo(d["infer"], cert, 1)
    p = ref_kpcn.to_device(ref_kpcn.load_params(weights), cuda)
    with no_tf32():
        want = ref_frame.denoise(lambda x: ref_kpcn.network(p, x, model), frame, "group", halo,
                                 cert, 1, cell["check"]["band_rows"])
    assert len(want) == 9 and out["combined"].shape == (*FRAME, 3)
    for k, r in want.items():
        gap = float((out[k].double() - r.double()).norm() / r.double().norm())
        assert gap <= cell["limits"]["rel_l2"], (k, gap)


def test_kpcn_denoise_through_the_cli_on_the_card(cuda, fourier_1080p, fourier_dir, tmp_path):
    """`denoise --config` (kpcn.json without its bench group, the fused
    ingest on) with the seeded weights: the frame's launches and a finite
    1080p output."""
    from deepdenoiser_tpu_torch import cli

    d, weights = _kpcn_config()
    d["infer"]["use_pallas_ingest"] = True
    path = tmp_path / "kpcn.json"
    path.write_text(json.dumps(d))
    _reset_launches()
    assert cli.main(["denoise", "--config", str(path), "--weights", str(weights), "--frame",
                     str(fourier_dir), "--out", str(tmp_path / "out.exr")]) == 0
    torch.cuda.synchronize()
    _expect_launches(kpn_apply=2, kpn_softmax=2, bias_act=9, group_encode=1)
    out = torch.from_numpy(exr.read_exr(tmp_path / "out.exr"))
    assert out.shape == (*FRAME, 3) and torch.isfinite(out).all()
