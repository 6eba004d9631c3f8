"""A conv's bias and activation as one op (ops/bias_act.py) on the CPU: its
plain version is the chain PyTorch runs after a cuDNN conv, bit for bit,
for every activation, both working dtypes, both layouts and the channel
counts of the frame cells' convs; the models through it still match the
JAX package; its gradients are the plain chain's; no conv of a model passes
a bias, every conv's output goes through the op once, and the CPU launches
nothing; the wrapper's argument checks.

The kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepdenoiser_tpu.models import layers as jlayers
from deepdenoiser_tpu.models import tiramisu as jtiramisu
from deepdenoiser_tpu.models import unet as junet
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.models import factory, layers, tiramisu, unet
from deepdenoiser_tpu_torch.ops import bias_act

REL_TOL = 1e-4  # the model tests' tolerance against the JAX package (fp32)
ACTS = sorted(bias_act.ACTIVATIONS)
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# 16: a tiramisu layer's growth; 48: its stem; 50: flagship-max's head;
# 64: kpn-hq's first level; 200: kpn-hq's head
CHANNELS = (16, 48, 50, 64, 200)
LAYOUTS = ("channels_last", "nchw")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread each, so that test workers sharing
    the cores do not spin on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(c, dtype, layout, n=2, h=3, w=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    z = (3 * torch.randn((n, c, h, w), generator=gen)).to(dtype)
    if layout == "channels_last":
        z = z.contiguous(memory_format=torch.channels_last)
    b = torch.randn((c,), generator=gen)  # fp32, as a conv's parameter
    return z, b


def _former_chain(z, b, act):
    """What ConvBlock ran after cuDNN's conv before the op: PyTorch's
    `_convolution` adds the bias, cast to the dtype, in place on the conv's
    output (`output.add_(reshape_bias(...))`), then the block applied its
    activation."""
    return bias_act.ACTIVATIONS[act](z.clone().add_(b.to(z.dtype).view(1, -1, 1, 1)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_plain_version_is_the_former_chain_bit_for_bit(act, dtype, c, layout):
    z, b = _inputs(c, DTYPES[dtype], layout, seed=c)
    want = _former_chain(z, b, act)
    bias_act.reset_launches()
    for got in (bias_act.bias_act_plain(z, b, act), bias_act.bias_act(z, b, act)):
        assert got.dtype == z.dtype and got.shape == z.shape
        assert torch.equal(got, want)
    assert bias_act.launches == 0


def test_the_kernel_codes_cover_every_activation_of_the_layers():
    assert set(bias_act.ACT_CODES) == set(bias_act.ACTIVATIONS)
    for act in bias_act.ACT_CODES:
        assert layers.ConvBlock(3, 4, act=act).act == act
    with pytest.raises(KeyError, match="unknown activation"):
        layers.ConvBlock(3, 4, act="tanh")
    assert len(set(bias_act.ACT_CODES.values())) == len(bias_act.ACT_CODES)


def _random_params(init, *args, seed):
    """The JAX parameter tree of `init`, filled with seeded numpy values:
    fan-in-scaled kernels, biases of 0.1 (tests/test_torch_models.py)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def fill(leaf):
        scale = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)], ids=["3x3", "3x3-s2", "1x1"])
@pytest.mark.parametrize("act", ACTS)
def test_conv_block_matches_jax(act, kernel, stride):
    x = np.random.default_rng(kernel + stride).standard_normal((2, 8, 12, 5)).astype(np.float32)
    jblock = jlayers.ConvBlock(6, kernel, stride, act)
    params = _random_params(jblock.init, jnp.asarray(x), seed=stride)
    want = np.asarray(jblock.apply(params, jnp.asarray(x)))
    block = layers.ConvBlock(5, 6, kernel, stride, act=act)
    weights_io.load_into(block, params)
    bias_act.reset_launches()
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _assert_close(got, want)
    assert bias_act.launches == 0


@pytest.mark.parametrize("act", ["relu", "elu", "gelu", "silu"])
@pytest.mark.parametrize("backbone", ["unet", "tiramisu"])
def test_backbones_match_jax_under_every_activation(backbone, act):
    cin, cout = 5, 7
    x = np.random.default_rng(11).standard_normal((2, 16, 24, cin)).astype(np.float32)
    if backbone == "unet":
        kw = dict(base_width=8, depth=2, act=act)
        jnet = junet.UNet(junet.UNetSpec(**kw), cout)
        net = unet.UNet(unet.UNetSpec(**kw), cin, cout)
    else:
        kw = dict(growth_rate=4, layers_per_block=2, depth=2, stem_width=6, up_compress=6, act=act)
        jnet = jtiramisu.Tiramisu(jtiramisu.TiramisuSpec(**kw), cout)
        net = tiramisu.Tiramisu(tiramisu.TiramisuSpec(**kw), cin, cout)
    params = _random_params(jnet.init, jnp.asarray(x), seed=12)
    want = jnet.apply(params, jnp.asarray(x))
    weights_io.load_into(net, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _assert_close(got.numpy(), want)


GRADS = [pytest.param(act, dtype, layout, wants, id=f"{act}-{dtype}-{layout}-{wants}")
         for act, dtype, layout, wants in itertools.product(
             ACTS, list(DTYPES), LAYOUTS, ("z+b", "z", "b"))]


@pytest.mark.parametrize("act,dtype,layout,wants", GRADS)
def test_gradients_are_the_plain_chains(act, dtype, layout, wants):
    """The op under autograd against autograd of the plain chain: the same
    output and the same gradients, bit for bit, for whichever of z and b
    require them."""
    z, b = _inputs(50, DTYPES[dtype], layout, seed=3)
    g = torch.randn(z.shape, generator=torch.Generator().manual_seed(4)).to(z.dtype)
    grads = []
    for fn in (bias_act.bias_act, bias_act.bias_act_plain):
        zz = z.clone().requires_grad_("z" in wants)
        bb = b.clone().requires_grad_("b" in wants)
        out = fn(zz, bb, act)
        leaves = [t for t in (zz, bb) if t.requires_grad]
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, g)))
    assert len(grads[0]) == len(grads[1]) == 1 + len(wants.split("+"))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_an_op_without_activation_keeps_no_activation_for_its_backward():
    """The linear head ("none") saves nothing; relu and leaky_relu save
    their output alone, as PyTorch's own backward of them does; elu, gelu
    and silu save z and the bias, whose chain the backward recomputes."""
    z, b = _inputs(16, torch.float32, "nchw")
    for act, kept in (("none", 0), ("relu", 1), ("leaky_relu", 1), ("elu", 2), ("gelu", 2),
                      ("silu", 2)):
        out = bias_act.bias_act(z.clone().requires_grad_(), b.clone().requires_grad_(), act)
        saved = out.grad_fn.saved_tensors
        assert len(saved) == kept, act
        if kept == 1:
            assert torch.equal(saved[0], out), act


def test_conv_block_gradients_match_the_former_conv_with_bias():
    """ConvBlock's weight, bias and input gradients against the block's
    former expression (the bias inside F.conv2d), in fp32 on the CPU, where
    oneDNN adds the bias inside the conv: equal to rounding."""
    block = layers.ConvBlock(5, 6, 3, act="leaky_relu")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 5, 8, 12), generator=gen).contiguous(memory_format=torch.channels_last)
    g = torch.randn((2, 6, 8, 12), generator=gen)
    conv = block.Conv_0
    grads = []
    for fn in (block, lambda t: F.leaky_relu(F.conv2d(t, conv.weight, conv.bias, padding=1), 0.2)):
        xx = x.clone().requires_grad_()
        out = fn(xx)
        grads.append((out, *torch.autograd.grad(out, [xx, conv.weight, conv.bias], g)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _conv_calls(monkeypatch):
    """Record every F.conv2d call's bias and every bias_act call."""
    seen = {"conv_bias": [], "bias_act": []}
    conv2d, op = F.conv2d, bias_act.bias_act

    def conv(x, w, bias=None, *a, **kw):
        seen["conv_bias"].append(bias)
        return conv2d(x, w, bias, *a, **kw)

    def counted(z, b, act):
        seen["bias_act"].append((z.shape[1], act))
        return op(z, b, act)

    monkeypatch.setattr(F, "conv2d", conv)  # the module every model file calls it through
    monkeypatch.setattr(bias_act, "bias_act", counted)
    return seen


@pytest.mark.parametrize("preset,convs", [("kpn-hq", 21), ("flagship-max", 21),
                                          ("tiramisu-lt1", 33)])
def test_no_conv_passes_a_bias_and_each_output_goes_through_the_op_once(
        monkeypatch, preset, convs):
    """The frame cells' models at their widths on a small plane, forward
    and backward: every conv runs without its bias, the op runs once a conv
    (21 in the UNets, 33 in tiramisu-lt1), the 1x1 head with no activation,
    and the CPU launches nothing."""
    cfg = config.validate_channels(config.PRESETS[preset])
    mcfg = cfg.model
    model = factory.init_model(mcfg, torch.Generator().manual_seed(0))
    seen = _conv_calls(monkeypatch)
    m = factory.spatial_multiple(mcfg)
    x = torch.rand((1, m, m, mcfg.in_channels), generator=torch.Generator().manual_seed(1),
                   requires_grad=True)
    bias_act.reset_launches()
    out = model(x)  # counted before the backward, which recomputes remat'd stacks
    assert len(seen["conv_bias"]) == convs and all(b is None for b in seen["conv_bias"])
    assert len(seen["bias_act"]) == convs
    assert [a for _, a in seen["bias_act"]].count("none") == 1
    assert seen["bias_act"][-1][1] == "none"
    assert all(a == mcfg.act for _, a in seen["bias_act"][:-1])
    out.sum().backward()
    assert bias_act.launches == 0
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _z(shape=(1, 8, 3, 4), dtype=torch.bfloat16):
    return torch.randn(shape).to(dtype)


REFUSED = {
    "strided z": (lambda: (_z((1, 8, 3, 8))[..., ::2], torch.ones(8), "relu"), ValueError,
                  "dense"),
    "permuted z": (lambda: (_z().permute(0, 1, 3, 2), torch.ones(8), "relu"), ValueError,
                   "dense"),
    "a channel slice": (lambda: (_z((2, 16, 3, 4))[:, :8], torch.ones(8), "relu"), ValueError,
                        "dense"),
    "bias of another length": (lambda: (_z(), torch.ones(7), "relu"), ValueError, r"\(C,\)"),
    "bias (1,C,1,1)": (lambda: (_z(), torch.ones(1, 8, 1, 1), "relu"), ValueError, r"\(C,\)"),
    "3-D z": (lambda: (_z()[0], torch.ones(8), "relu"), ValueError, r"\(N,C,H,W\)"),
    "strided bias": (lambda: (_z(), torch.ones(16)[::2], "relu"), ValueError, "contiguous"),
    "float16 z": (lambda: (_z(dtype=torch.float16), torch.ones(8), "relu"), TypeError,
                  "bfloat16 or float32"),
    "float64 z": (lambda: (_z(dtype=torch.float64), torch.ones(8), "relu"), TypeError,
                  "bfloat16 or float32"),
    "float64 bias": (lambda: (_z(), torch.ones(8, dtype=torch.float64), "relu"), TypeError,
                     "float32 or z's"),
    "unknown activation": (lambda: (_z(), torch.ones(8), "tanh"), KeyError, "unknown"),
    "bias on another device": (lambda: (_z(), torch.ones(8, device="meta"), "relu"), ValueError,
                               "one device"),
    "z 2 B past a 16 B boundary": (lambda: (_z((97,))[1:].view(1, 8, 3, 4), torch.ones(8), "relu"),
                                   ValueError, "16-byte aligned"),
}


@pytest.mark.parametrize("entry", ["bias_act", "bias_act_cuda"])
@pytest.mark.parametrize("case", list(REFUSED))
def test_the_op_refuses_what_the_kernel_does_not_take(case, entry):
    make, err, match = REFUSED[case]
    z, b, act = make()
    bias_act.reset_launches()
    with pytest.raises(err, match=match):
        if entry == "bias_act":
            bias_act.bias_act(z, b, act)
        else:
            bias_act.bias_act_cuda(z, b, act, z)
    assert bias_act.launches == 0


def test_the_kernel_entry_refuses_cpu_tensors():
    z, b = _inputs(16, torch.bfloat16, "channels_last")
    bias_act.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        bias_act.bias_act_cuda(z, b, "leaky_relu", z)
    assert bias_act.launches == 0
