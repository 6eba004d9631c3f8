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


@pytest.mark.parametrize("aux", [(), ("depth",), ("alpha",), ("normal", "depth"),
                                 ("normal", "depth", "alpha")], ids=str)
@pytest.mark.parametrize("lead", [(37, 53), (2, 20, 36)], ids=str)
def test_group_encode_writes_strided_channel_ranges(cuda, aux, lead):
    """encode_group_inputs_fused points the kernels at channel ranges of one
    preallocated stack: the strided-output path, with unaligned bases."""
    pd = _raw_passes(lead, cuda, seed=3)
    fused_ingest.reset_launches()
    got = fused_ingest.encode_group_inputs_fused(pd, "glossy", aux)
    want = transforms.encode_group_inputs(pd, "glossy", aux)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _ingest_within(got, want)
    n = fused_ingest.launches
    assert n["radiance"] == 1 and n["normal"] == int("normal" in aux)
    both = "depth" in aux and "alpha" in aux
    assert n["depth_alpha"] == int(both)
    assert n["depth"] == int("depth" in aux and not both)
    assert n["alpha"] == int("alpha" in aux and not both)


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
    """The group frame at fp32 (TF32 off) with the fused ingest launches K2-K4
    once per group and K1 once per slot, and agrees with the same port on the
    CPU (held to the JAX package by tests/test_torch_modes.py)."""
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
        assert fused_ingest.launches == {"radiance": 4, "normal": 4, "depth_alpha": 4,
                                         "depth": 0, "alpha": 0}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    den_cpu, _ = pipeline.make_group_frame_denoiser(cfg.model, icfg, h, w, params, device="cpu")
    want = den_cpu(frame)
    assert set(got) == set(want)
    for name, ref in want.items():
        err = (got[name].cpu() - ref).abs().max()
        assert err <= 1e-4 * ref.abs().max(), (name, float(err))
