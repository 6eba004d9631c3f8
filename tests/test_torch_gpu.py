"""The port on the card: every CUDA kernel against its plain PyTorch version,
and the joint- and group-mode frame denoise through the kernels.

Every test here carries the `gpu` marker and skips without a CUDA card. The
file imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu_torch import config, transforms, weights_io
from deepdenoiser_tpu_torch.data import mc_tracer, synthetic, synthetic_device
from deepdenoiser_tpu_torch.data.draws import seeded
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory, kpn, layers
from deepdenoiser_tpu_torch.ops import bias_act, fused_ingest, kpn_apply, kpn_softmax

import torch_flips  # noqa: E402  (tests/, on the path of every test module)

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest tests/test_torch_gpu.py -m gpu)")
    return torch.device("cuda")


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
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        den_gpu, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        got = den_gpu(frame)["combined"]
        torch.cuda.synchronize()
        assert kpn_apply.launches == cfg.model.kpn_slots
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    den_cpu, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params, device="cpu")
    want = den_cpu(frame)["combined"].numpy()
    err = np.abs(got.cpu().numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


# --------------------------------------------------------------------------
# the fused-ingest kernels
# --------------------------------------------------------------------------

INGEST_SHAPES = [(37, 53), (2, 20, 36), (64, 96), (1, 1)]


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
@pytest.mark.parametrize("lead", [(64, 96), (2, 20, 36), (37, 53), (7, 9), (1, 1)], ids=str)
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
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        den_gpu, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        fused_ingest.reset_launches()
        got = den_gpu(frame)
        torch.cuda.synchronize()
        assert kpn_apply.launches == cfg.model.kpn_slots
        assert fused_ingest.launches == {"radiance": 0, "normal": 0, "depth_alpha": 0,
                                         "depth": 0, "alpha": 0, "group_encode": 1}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    den_cpu, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, h, w, params, device="cpu")
    want = den_cpu(frame)
    assert set(got) == set(want)
    for name, ref in want.items():
        err = (got[name].cpu() - ref).abs().max()
        assert err <= 1e-4 * ref.abs().max(), (name, float(err))


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
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
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
    ((2, 30, 41), 5, 8, False, True), ((1, 1, 3), 5, 8, True, False)])
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
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        banded, _ = pipeline.make_joint_frame_denoiser(
            cfg.model, icfg, h, w, params, mesh=mesh.make_mesh(2, "spatial", devices=["cuda"] * 2))
        whole, _ = pipeline.make_joint_frame_denoiser(cfg.model, icfg, h, w, params)
        kpn_apply.reset_launches()
        got = banded(frame)
        torch.cuda.synchronize()
        assert kpn_apply.launches == 2 * cfg.model.kpn_slots
        want = whole(frame)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
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
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = train.create_state(m, t, params=weights_io.unflatten(params))
        step = train.make_train_step(m, t)
        for got in res[0]["mets"]:
            state, want = step(state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
            for k in ("loss", "grad_norm"):
                assert got[k] == pytest.approx(float(want[k]), rel=1e-5), k
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
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
EPILOGUE_PRESETS = {"kpn-hq": 21, "flagship-max": 21, "tiramisu-lt1": 33}
EXACT_ACTS = ("leaky_relu", "relu", "none")


@functools.lru_cache(maxsize=None)
def _conv_output_shapes(preset: str) -> tuple:
    """The distinct (N,C,H,W) conv outputs of the preset's network over the
    1080p plane (group mode: four groups a batch), read off one forward on
    the card at random weights."""
    mcfg = config.validate_channels(config.PRESETS[preset]).model
    model = factory.init_model(mcfg, torch.Generator().manual_seed(0)).to("cuda")
    n = 4 if mcfg.out_channels == 6 else 1
    x = torch.rand((n, *PLANE, mcfg.in_channels), device="cuda")
    shapes = []
    op = bias_act.bias_act

    def seen(z, b, act):
        shapes.append(tuple(z.shape))
        return op(z, b, act)

    bias_act.bias_act = seen
    try:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        bias_act.bias_act = op
    assert len(shapes) == EPILOGUE_PRESETS[preset]
    return tuple(sorted(set(shapes)))


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
@pytest.mark.parametrize("preset", list(EPILOGUE_PRESETS))
def test_bias_act_kernel_matches_plain_version_at_every_backbone_shape(cuda, preset, act):
    """Every conv output shape of the three frame cells' networks at the
    1080p plane, bf16, channels-last as the path lays them out."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    shapes = _conv_output_shapes(preset)
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


def _frame_1080p():
    """A 1080p frame on the host: the Fourier family at 270x480, each pixel
    repeated 4x4."""
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(270, 480, seed=5), spp=4,
                                   seed=6)
    return {k: torch.from_numpy(np.repeat(np.repeat(v, 4, axis=0), 4, axis=1))
            for k, v in noisy.items()}


def _plain_epilogue(z, b, act):
    return bias_act.bias_act_plain(z, b, act)


def test_kpn_hq_1080p_frame_equals_the_plain_epilogue_bit_for_bit(cuda, monkeypatch):
    """The release kpn-hq frame denoiser (bf16) at 1080p: 21 launches a
    frame, and every output pass equal to the same frame with the plain
    chain in the kernel's place."""
    cfg = config.validate_channels(config.PRESETS["kpn-hq"])
    params = weights_io.load_release_params(REPO / "weights" / "kpn_hq_ema_f16.npz")
    frame = _frame_1080p()
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, 1080, 1920, params)
    bias_act.reset_launches()
    got = den(frame)
    torch.cuda.synchronize()
    assert bias_act.launches == 21
    monkeypatch.setattr(bias_act, "bias_act", _plain_epilogue)
    want = den(frame)
    assert bias_act.launches == 21
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("preset,weights", [("kpn-hq", "kpn_hq_ema_f16.npz"),
                                            ("tiramisu-lt1", "tiramisu_lt1_ema_f16.npz")])
def test_frame_denoisers_launch_one_epilogue_a_conv(cuda, preset, weights):
    cfg = config.validate_channels(config.PRESETS[preset])
    params = weights_io.load_release_params(REPO / "weights" / weights)
    h, w = 64, 96
    noisy = synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=5), spp=4, seed=6)
    frame = {k: torch.from_numpy(v) for k, v in noisy.items()}
    den, _ = pipeline.make_joint_frame_denoiser(cfg.model, cfg.infer, h, w, params)
    bias_act.reset_launches()
    for _ in range(2):
        den(frame)
    torch.cuda.synchronize()
    assert bias_act.launches == 2 * EPILOGUE_PRESETS[preset]


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
