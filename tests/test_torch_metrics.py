"""The port's image metrics against the JAX package's on the same numpy
inputs, on the CPU: psnr_per_image, ssim (with return_map), ms_ssim, the
Gaussian window and the separable filter, atol 1e-5, odd-sized inputs
included. The per-pixel SSIM map is held at 1e-4: each of its pixels is a
ratio of differences E[x²] - E[x]², which fp32 resolves to about 3e-5 here
(both packages sit that far from a float64 evaluation, in different
pixels); its mean is held at 1e-5 like the rest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu_torch.ops import metrics

ATOL = 1e-5
MAP_ATOL = 1e-4


def _pair(seed, *shape, noise=0.1):
    """A smooth image in [0, 1] and a noisy copy of it."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    yy, xx = (g[None, ..., None] for g in np.mgrid[0:h, 0:w])
    base = 0.5 + 0.25 * np.sin(xx / 7.0 + rng.uniform(0, 3, (n, 1, 1, c))) * np.cos(yy / 5.0)
    base = base + 0.2 * rng.random((n, h, w, c))
    noisy = np.clip(base + noise * rng.standard_normal(base.shape), 0, 1)
    return base.astype(np.float32), noisy.astype(np.float32)


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("size,sigma", [(11, 1.5), (7, 1.0), (5, 0.8)])
def test_gaussian_kernel_is_bit_equal_to_jax(size, sigma):
    np.testing.assert_array_equal(metrics._gaussian_kernel(size, sigma),
                                  jmetrics._gaussian_kernel(size, sigma))
    assert metrics.MSSSIM_WEIGHTS == jmetrics.MSSSIM_WEIGHTS


@pytest.mark.parametrize("shape", [(2, 33, 47, 3), (1, 24, 24, 1), (1, 11, 40, 2)])
def test_filter2d_matches_jax(shape):
    x, _ = _pair(0, *shape)
    w = metrics._gaussian_kernel(11, 1.5)
    want = np.asarray(jmetrics._filter2d(jnp.asarray(x), w))
    got = metrics._filter2d(_t(x), w)
    assert tuple(got.shape) == want.shape == (shape[0], shape[1] - 10, shape[2] - 10, shape[3])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="smaller"):
        metrics._filter2d(torch.zeros(1, 10, 40, 1), w)


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 33, 47, 3), (3, 21, 16, 1)],
                         ids=["even", "odd", "small-gray"])
@pytest.mark.parametrize("data_range", [1.0, 4.0])
def test_psnr_and_ssim_match_jax(shape, data_range):
    ref, noisy = _pair(1, *shape)
    ref, noisy = ref * data_range, noisy * data_range
    np.testing.assert_allclose(
        metrics.psnr_per_image(_t(noisy), _t(ref), data_range).numpy(),
        np.asarray(jmetrics.psnr_per_image(jnp.asarray(noisy), jnp.asarray(ref), data_range)),
        atol=1e-4)  # dB: log10 of a mean of 1e3..1e4 fp32 terms
    want = np.asarray(jmetrics.ssim(jnp.asarray(noisy), jnp.asarray(ref), data_range))
    got = metrics.ssim(_t(noisy), _t(ref), data_range)
    assert tuple(got.shape) == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert (got < 0.999).all() and (got > 0).all()
    np.testing.assert_allclose(metrics.ssim(_t(ref), _t(ref), data_range).numpy(), 1.0, atol=ATOL)
    np.testing.assert_allclose(
        float(metrics.psnr(_t(noisy), _t(ref), data_range)),
        float(jmetrics.psnr(jnp.asarray(noisy), jnp.asarray(ref), data_range)), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(window_size=7, sigma=1.0), dict(k1=0.02, k2=0.05)],
                         ids=["default", "window7", "k"])
def test_ssim_map_matches_jax(kw):
    ref, noisy = _pair(2, 2, 33, 47, 3)
    want = np.asarray(jmetrics.ssim(jnp.asarray(noisy), jnp.asarray(ref), return_map=True, **kw))
    got = metrics.ssim(_t(noisy), _t(ref), return_map=True, **kw)
    k = kw.get("window_size", 11)
    assert tuple(got.shape) == want.shape == (2, 33 - k + 1, 47 - k + 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=MAP_ATOL)
    np.testing.assert_allclose(got.mean(dim=(1, 2, 3)).numpy(), want.mean(axis=(1, 2, 3)),
                               atol=ATOL)
    np.testing.assert_allclose(got.mean(dim=(1, 2, 3)).numpy(),
                               metrics.ssim(_t(noisy), _t(ref), **kw).numpy(), atol=1e-6)


def test_ssim_takes_bf16_inputs_in_fp32_and_wants_nhwc():
    ref, noisy = _pair(3, 1, 32, 32, 3)
    got = metrics.ssim(_t(noisy).bfloat16(), _t(ref).bfloat16())
    want = metrics.ssim(_t(noisy).bfloat16().float(), _t(ref).bfloat16().float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(AssertionError, match="NHWC"):
        metrics.ssim(_t(noisy)[0], _t(ref)[0])


@pytest.mark.parametrize("shape,n_scales", [
    ((2, 192, 208, 3), 5), ((1, 181, 203, 3), 5), ((1, 45, 47, 1), 3), ((2, 96, 112, 3), 4),
    ((1, 33, 47, 3), 1),
], ids=["even-5", "odd-5", "odd-3", "even-4", "one-scale"])
def test_ms_ssim_matches_jax(shape, n_scales):
    """The 2x2 VALID pool between scales drops an odd last row or column."""
    ref, noisy = _pair(4, *shape, noise=0.2)
    want = np.asarray(jmetrics.ms_ssim(jnp.asarray(noisy), jnp.asarray(ref), n_scales=n_scales))
    got = metrics.ms_ssim(_t(noisy), _t(ref), n_scales=n_scales)
    assert tuple(got.shape) == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert (got < 0.999).all() and (got > 0).all()


def test_ssim_and_cs_and_tonemap_match_jax():
    ref, noisy = _pair(5, 2, 40, 40, 3)
    want = jmetrics._ssim_and_cs(jnp.asarray(noisy), jnp.asarray(ref), 1.0, 11, 1.5)
    got = metrics._ssim_and_cs(_t(noisy), _t(ref), 1.0, 11, 1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    hdr = (ref * 20 - 2).astype(np.float32)
    np.testing.assert_allclose(metrics.tonemap_for_metrics(_t(hdr)).numpy(),
                               np.asarray(jmetrics.tonemap_for_metrics(jnp.asarray(hdr))),
                               atol=1e-6)
