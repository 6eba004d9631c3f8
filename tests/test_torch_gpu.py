"""The port on the card: every CUDA kernel against its plain PyTorch version,
and the joint- and group-mode frame denoise through the kernels.

Every test here carries the `gpu` marker and skips without a CUDA card. The
file imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu_torch import config, transforms, weights_io
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import fused_ingest, kpn_apply

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


def test_kpn_kernel_takes_the_heads_strided_views(cuda):
    """The head hands the kernel a 3-channel slice of the 24-channel signal
    stack and a permuted view of planar (N, k², H, W) softmax weights."""
    k = 5
    g = torch.Generator(device=cuda).manual_seed(1)
    noisy = torch.rand((1, 40, 72, 24), generator=g, device=cuda)[..., 9:12]
    weights = torch.softmax(torch.randn((1, k * k, 40, 72), generator=g, device=cuda), 1)
    weights = weights.permute(0, 2, 3, 1)
    got = kpn_apply.apply_per_pixel_kernels(noisy, weights, k)
    want = kpn.apply_per_pixel_kernels(noisy.contiguous(), weights.contiguous(), k)
    torch.cuda.synchronize()
    assert _within(got, want)


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
    """The head's strided views, as in training: the signal is a slice of
    the input (no gradient), the weights a permuted planar softmax."""
    k = 5
    gen = torch.Generator(device=cuda).manual_seed(5)
    stack = torch.rand((2, 24, 40, 24), generator=gen, device=cuda)
    logits = torch.randn((2, k * k, 24, 40), generator=gen, device=cuda, requires_grad=True)
    g = torch.randn((2, 24, 40, 3), generator=gen, device=cuda)
    kpn_apply.reset_launches()
    out = kpn_apply.apply_per_pixel_kernels(stack[..., 3:6], torch.softmax(logits, 1).permute(0, 2, 3, 1), k)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (kpn_apply.launches, kpn_apply.bwd_weights_launches, kpn_apply.bwd_noisy_launches) == (1, 1, 0)
    ref_logits = logits.detach().cpu().requires_grad_()
    ref = kpn.apply_per_pixel_kernels(stack[..., 3:6].cpu(), torch.softmax(ref_logits, 1).permute(0, 2, 3, 1), k)
    (ref * g.cpu()).sum().backward()
    assert _within(logits.grad.cpu(), ref_logits.grad)
    with torch.inference_mode():
        kpn_apply.reset_launches()
        kpn_apply.apply_per_pixel_kernels(stack[..., 3:6], torch.softmax(logits, 1).permute(0, 2, 3, 1), k)
        assert (kpn_apply.launches, kpn_apply.bwd_weights_launches) == (1, 0)
