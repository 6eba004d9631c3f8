"""The port on the card: every CUDA kernel against its plain PyTorch version,
and the joint-mode frame denoise through the kernel.

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

from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.data import synthetic
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import kpn
from deepdenoiser_tpu_torch.ops import kpn_apply

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
