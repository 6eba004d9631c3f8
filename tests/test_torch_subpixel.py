"""The decoder's resize-conv as a sub-pixel conv on the coarse grid
(models/layers.UpSample, ops/bias_act.bias_act_subpixel) on the CPU: it
equals nearest-up(2) then the 3x3 SAME conv in fp32, for every activation,
even and odd coarse sizes, batches and the frame cells' channel counts; it
matches the JAX package's UpSample; its gradients are the resize-then-conv
form's; the folded kernel follows the weight; other kernels and factors keep
the resize; the plain interleave puts each phase in its place; and the
kernel's entry refuses what it does not take.

The kernel's sub-pixel instantiation is held to the plain interleave and
epilogue on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu.models import layers as jlayers
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.models import factory, layers
from deepdenoiser_tpu_torch.ops import bias_act
from test_torch_models import REL_TOL, _random_params

ACTS = sorted(bias_act.ACTIVATIONS)
# max|Δ| / max|ref| of the folded kernel's fp32 sums (4C terms a phase)
# against the resized input's (9C, in another order): up to 2.2e-6 at C = 128
# over 5 seeds and every activation, 6.7e-7 at C = 120, 4.7e-7 below
SUBPIXEL_TOL = 5e-6
# (N, C, F, H, W) of the coarse input: odd and even sizes, C != F, a
# tiramisu-lt1 transition (120 -> 64), kpn-hq's finest level (128 -> 64)
SHAPES = {
    "odd": (1, 5, 7, 3, 5),
    "even-batch": (3, 8, 4, 4, 6),
    "one-pixel": (2, 6, 3, 1, 1),
    "tiramisu": (1, 120, 64, 5, 4),
    "kpn-hq": (2, 128, 64, 3, 3),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread each, so that test workers sharing
    the cores do not spin on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _upsample(c, f, act, kernel=3, factor=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    up = layers.UpSample(c, f, kernel, act=act, factor=factor)
    with torch.no_grad():
        layers.lecun_normal_(up.ConvBlock_0.Conv_0.weight, gen)
        up.ConvBlock_0.Conv_0.bias.copy_(0.3 * torch.randn((f,), generator=gen))
    return up


def _resize_then_conv(up, x):
    """The form the sub-pixel conv replaces: the resized input, the conv
    with its bias, the activation (plain PyTorch)."""
    conv = up.ConvBlock_0.Conv_0
    k = conv.weight.shape[-1]
    big = F.interpolate(x, scale_factor=up.factor, mode="nearest")
    return bias_act.ACTIVATIONS[up.ConvBlock_0.act](
        F.conv2d(big, conv.weight, conv.bias, padding=k // 2))


def _input(n, c, h, w, seed=1):
    x = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(seed))
    return x.contiguous(memory_format=torch.channels_last)


def _assert_close(got, want, tol):
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_subpixel_upsample_equals_resize_then_conv(shape, act):
    n, c, f, h, w = SHAPES[shape]
    up = _upsample(c, f, act)
    assert up.subpixel
    x = _input(n, c, h, w)
    with torch.no_grad():
        got = up(x)
        want = _resize_then_conv(up, x)
    assert got.dtype == torch.float32 and got.shape == (n, f, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_close(got, want, SUBPIXEL_TOL)


def test_a_sequence_input_is_joined_first():
    up = _upsample(9, 4, "leaky_relu")
    a, b = _input(2, 5, 3, 4, seed=2), _input(2, 4, 3, 4, seed=3)
    with torch.no_grad():
        got = up((a, b))
        want = _resize_then_conv(up, torch.cat((a, b), dim=1))
    _assert_close(got, want, SUBPIXEL_TOL)


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "gelu"])
@pytest.mark.parametrize("shape", [(1, 6, 10, 8, 4), (2, 5, 7, 6, 3)], ids=["even", "odd"])
def test_subpixel_upsample_matches_jax(shape, act):
    n, h, w, c, f = shape
    x = np.random.default_rng(h * w).standard_normal((n, h, w, c)).astype(np.float32)
    jup = jlayers.UpSample(f, 3, act)
    params = _random_params(jup.init, jnp.asarray(x), seed=h + w)
    want = np.array(jup.apply(params, jnp.asarray(x)))
    up = layers.UpSample(c, f, 3, act=act)
    weights_io.load_into(up, params)
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _assert_close(got, torch.from_numpy(want), REL_TOL)


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "none", "elu", "silu"])
@pytest.mark.parametrize("shape", ["odd", "even-batch"])
def test_gradients_equal_the_resize_then_conv_forms(shape, act):
    n, c, f, h, w = SHAPES[shape]
    up = _upsample(c, f, act)
    x = _input(n, c, h, w)
    g = torch.randn((n, f, 2 * h, 2 * w), generator=torch.Generator().manual_seed(4))
    conv = up.ConvBlock_0.Conv_0
    grads = []
    for fn in (up, lambda t: _resize_then_conv(up, t)):
        xx = x.clone().requires_grad_()
        out = fn(xx)
        grads.append((out, *torch.autograd.grad(out, [xx, conv.weight, conv.bias], g)))
    for got, want in zip(*grads):  # the output, then d_x, d_w, d_b
        _assert_close(got, want, SUBPIXEL_TOL)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_the_folded_kernel_follows_the_weight(mode):
    """Without gradients the folded kernel is kept between calls, and a
    weight changed in place (load_state_dict, an update) folds anew."""
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    up, other = _upsample(6, 4, "relu", seed=0), _upsample(6, 4, "relu", seed=5)
    x = _input(1, 6, 3, 5)
    with ctx():
        first = up(x)
        kept = up._folded[1]
        assert torch.equal(up(x), first) and up._folded[1] is kept
        up.load_state_dict(other.state_dict())
        loaded = up(x)
        assert up._folded[1] is not kept
        assert torch.equal(loaded, other(x)) and not torch.equal(loaded, first)
    with torch.no_grad():
        up.ConvBlock_0.Conv_0.weight.mul_(2.0)
    with ctx():
        _assert_close(up(x), _resize_then_conv(up, x), SUBPIXEL_TOL)


def test_under_grad_the_kernel_is_folded_each_call_and_not_kept():
    up = _upsample(4, 4, "relu")
    up(_input(1, 4, 2, 2)).sum().backward()
    assert up._folded is None
    assert up.ConvBlock_0.Conv_0.weight.grad is not None


@pytest.mark.parametrize("kernel,factor", [(5, 2), (3, 3), (1, 2)])
def test_other_kernels_and_factors_keep_the_resize(monkeypatch, kernel, factor):
    seen = []
    sub = bias_act.bias_act_subpixel

    def counted(z, b, act):
        seen.append(z.shape)
        return sub(z, b, act)

    monkeypatch.setattr(bias_act, "bias_act_subpixel", counted)
    up = _upsample(5, 3, "leaky_relu", kernel=kernel, factor=factor)
    assert not up.subpixel
    x = _input(2, 5, 3, 4)
    with torch.no_grad():
        got = up(x)
        want = _resize_then_conv(up, x)
    assert got.shape == (2, 3, 3 * factor, 4 * factor) and seen == []
    _assert_close(got, want, SUBPIXEL_TOL)


@pytest.mark.parametrize("preset,calls", [("kpn-hq", 3), ("flagship-max", 3),
                                          ("tiramisu-lt1", 3)])
def test_each_decoder_level_runs_the_subpixel_epilogue_once(monkeypatch, preset, calls):
    """The frame cells' models on a small plane: every UpSample takes the
    sub-pixel path, and the CPU launches nothing."""
    mcfg = config.validate_channels(config.PRESETS[preset]).model
    model = factory.init_model(mcfg, torch.Generator().manual_seed(0))
    seen = []
    sub = bias_act.bias_act_subpixel

    def counted(z, b, act):
        seen.append((tuple(z.shape), act))
        return sub(z, b, act)

    monkeypatch.setattr(bias_act, "bias_act_subpixel", counted)
    m = factory.spatial_multiple(mcfg)
    x = torch.rand((1, 2 * m, m, mcfg.in_channels), generator=torch.Generator().manual_seed(1))
    bias_act.reset_launches()
    with torch.inference_mode():
        model(x)
    assert len(seen) == calls and all(a == mcfg.act for _, a in seen)
    assert bias_act.launches == 0 and bias_act.subpixel_launches == 0


@pytest.mark.parametrize("shape", [(1, 4, 2, 3), (2, 12, 4, 4), (1, 8, 5, 2)])
def test_the_plain_interleave_puts_each_phase_in_its_place(shape):
    n, c4, hz, wz = shape
    f, h, w = c4 // 4, hz - 1, wz - 1
    z = torch.arange(n * c4 * hz * wz, dtype=torch.float32).reshape(shape)
    z = z.contiguous(memory_format=torch.channels_last)
    got = bias_act.interleave_phases(z)
    assert got.shape == (n, f, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = torch.empty((n, f, 2 * h, 2 * w))
    for i in range(h):
        for j in range(w):
            for r in (0, 1):
                for q in (0, 1):
                    block = (2 * r + q) * f
                    want[:, :, 2 * i + r, 2 * j + q] = z[:, block:block + f, i + r, j + q]
    assert torch.equal(got, want)


def _phases(shape=(1, 16, 3, 4), dtype=torch.bfloat16):
    return torch.randn(shape).to(dtype).contiguous(memory_format=torch.channels_last)


REFUSED = {
    "NCHW z": (lambda: (torch.randn((1, 16, 3, 4)).to(torch.bfloat16), torch.ones(4)),
               ValueError, "channels-last"),
    "channels not four blocks": (lambda: (_phases((1, 6, 3, 4)), torch.ones(2)), ValueError,
                                 r"4F, H\+1, W\+1"),
    "one row of phases": (lambda: (_phases((1, 16, 1, 4)), torch.ones(4)), ValueError,
                          r"4F, H\+1, W\+1"),
    "bias of all 4F channels": (lambda: (_phases(), torch.ones(16)), ValueError, r"\(C/4,\)"),
    "float16 z": (lambda: (_phases(dtype=torch.float16), torch.ones(4)), TypeError,
                  "bfloat16 or float32"),
    "z 2 B past a 16 B boundary": (
        lambda: (torch.randn((1 + 16 * 3 * 4,)).to(torch.bfloat16)[1:].view(1, 3, 4, 16)
                 .permute(0, 3, 1, 2), torch.ones(4)), ValueError, "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_kernel_entry_refuses_what_it_does_not_take(case):
    make, err, match = REFUSED[case]
    z, b = make()
    bias_act.reset_launches()
    with pytest.raises(err, match=match):
        bias_act.bias_act_subpixel_cuda(z, b, "leaky_relu")
    assert bias_act.launches == 0 and bias_act.subpixel_launches == 0


def test_the_kernel_entry_refuses_cpu_tensors():
    bias_act.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        bias_act.bias_act_subpixel_cuda(_phases(), torch.ones(4), "relu")
    assert bias_act.launches == 0 and bias_act.subpixel_launches == 0


def test_plain_version_is_the_interleave_then_the_plain_epilogue():
    z, b = _phases(), torch.randn(4)
    want = bias_act.bias_act_plain(bias_act.interleave_phases(z), b, "silu")
    assert torch.equal(bias_act.bias_act_subpixel_plain(z, b, "silu"), want)
    assert torch.equal(bias_act.bias_act_subpixel(z, b, "silu"), want)
