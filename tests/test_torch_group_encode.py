"""The port's whole-pixel group encode (ops/fused_ingest.encode_groups_fused)
against the JAX package's fused ingest.

On the CPU the wrapper runs its plain version (the stacked
transforms.encode_group_inputs), so these tests hold that against
encode_group_inputs_pallas in interpret mode (as tests/test_pallas.py runs
it) stacked over the groups, on the same numpy inputs, and against the
per-pass route. Inputs reach every clamp: negative radiance, albedo 0,
normals beyond [-1, 1], alpha outside [0, 1], negative depth. Tolerance:
atol 1e-6 (the same fp32 operations; log1p's and the division's last bit).
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_gpu.py; here the wrapper's Python side
(shapes, `out`, refusals, channel offsets, the C argument list) is checked.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.ops import fused_ingest as jfused
from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.ops import fused_ingest

REPO = Path(__file__).resolve().parents[1]
AUX_SUBSETS = [(), ("depth",), ("alpha",), ("normal", "depth"), ("normal", "depth", "alpha")]
GROUPS = passes.LIGHT_GROUPS


def _raw_passes(lead, seed=0):
    rng = np.random.default_rng(seed)

    def rand(c, lo, hi):
        return (lo + (hi - lo) * rng.random((*lead, c))).astype(np.float32)

    pd = {"normal": rand(3, -1.5, 1.5), "depth": rand(1, -2.0, 30.0), "alpha": rand(1, -0.5, 1.5)}
    for grp in GROUPS:
        pd[f"{grp}_direct"] = rand(3, -1.0, 20.0)
        pd[f"{grp}_indirect"] = rand(3, -1.0, 5.0)
        pd[f"{grp}_color"] = np.maximum(rand(3, -0.2, 1.0), 0.0)  # a fifth exactly 0
    return pd


def _torch(pd):
    return {k: torch.from_numpy(v) for k, v in pd.items()}


@pytest.mark.parametrize("lead", [(24, 40), (2, 12, 20), (7, 9)], ids=["hwc", "nhwc", "ragged"])
@pytest.mark.parametrize("n_groups", [1, 2, 4])
@pytest.mark.parametrize("aux", AUX_SUBSETS, ids=str)
def test_group_encode_matches_the_stacked_pallas_encode(aux, n_groups, lead):
    pd = _raw_passes(lead, seed=n_groups)
    for a in passes.AUX_PASSES:
        if a not in aux:
            del pd[a]  # a subset must not reach for passes it was not asked for
    groups = GROUPS[:n_groups]
    fused_ingest.reset_launches()
    got = fused_ingest.encode_groups_fused(_torch(pd), groups, aux)
    assert sum(fused_ingest.launches.values()) == 0  # CPU tensors launch nothing
    jd = {k: jnp.asarray(v) for k, v in pd.items()}
    want = np.stack([
        np.asarray(jfused.encode_group_inputs_pallas(jd, g, aux=aux, interpret=True))
        for g in groups
    ], 0)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (
        n_groups, *lead, transforms.group_input_channels(aux))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("aux", [*AUX_SUBSETS, ("alpha", "normal"), ("depth", "alpha", "normal")],
                         ids=str)
def test_group_encode_equals_the_per_pass_route_exactly(aux):
    """One launch's worth of work against the per-pass functions writing
    their channel ranges, in the caller's aux order."""
    td = _torch(_raw_passes((12, 20), seed=5))
    got = fused_ingest.encode_groups_fused(td, GROUPS, aux)
    for i, g in enumerate(GROUPS):
        per_pass = fused_ingest.encode_group_inputs_per_pass(td, g, aux)
        torch.testing.assert_close(got[i], per_pass, atol=0, rtol=0)
        torch.testing.assert_close(got[i], transforms.encode_group_inputs(td, g, aux),
                                   atol=0, rtol=0)
        torch.testing.assert_close(fused_ingest.encode_group_inputs_fused(td, g, aux), got[i],
                                   atol=0, rtol=0)
    # and every clamp was reached
    full = fused_ingest.encode_groups_fused(td, GROUPS)
    assert float(full[..., 0:6].min()) == 0.0 and float(full[..., 9:12].max()) == 1.0
    assert float(full[..., 12].min()) == 0.0
    assert float(full[..., 13].min()) == 0.0 and float(full[..., 13].max()) == 1.0


def test_group_encode_writes_into_a_given_out():
    td = _torch(_raw_passes((12, 20), seed=4))
    out = torch.full((3, 2, 12, 20, 14), -7.0)
    ret = fused_ingest.encode_groups_fused(td, ("glossy", "diffuse"), out=out[1])
    assert ret.data_ptr() == out[1].data_ptr()
    for i, g in enumerate(("glossy", "diffuse")):
        torch.testing.assert_close(out[1, i], transforms.encode_group_inputs(td, g),
                                   atol=0, rtol=0)
    assert bool((out[0] == -7.0).all()) and bool((out[2] == -7.0).all())
    # the one-group form takes a slice of the same batch
    one = fused_ingest.encode_group_inputs_fused(td, "transmission", out=out[2, 1])
    assert one.data_ptr() == out[2, 1].data_ptr()
    torch.testing.assert_close(out[2, 1], transforms.encode_group_inputs(td, "transmission"),
                               atol=0, rtol=0)
    assert bool((out[2, 0] == -7.0).all())


@pytest.mark.parametrize("make,error,match", [
    (lambda: torch.empty((2, 8, 8, 13)), ValueError, "out"),
    (lambda: torch.empty((1, 8, 8, 14)), ValueError, "out"),
    (lambda: torch.empty((2, 8, 8, 28))[..., ::2], ValueError, r"contiguous.*strides \(1792, 224, 28, 2\)"),
    (lambda: torch.empty((2, 8, 14, 8)).transpose(2, 3), ValueError, "contiguous.*strides"),
    (lambda: torch.empty(2 * 8 * 8 * 14 + 1)[1:].view(2, 8, 8, 14), ValueError, "16-byte aligned"),
    (lambda: torch.empty((2, 8, 8, 14), dtype=torch.float16), TypeError, "fp32"),
], ids=["channels", "groups", "strided", "transposed", "misaligned", "fp16"])
def test_group_encode_refuses_an_out_it_cannot_write_whole(make, error, match):
    """`out` is written as whole float4s: any other layout raises, with the
    strides in the message, instead of taking another route."""
    td = _torch(_raw_passes((8, 8)))
    with pytest.raises(error, match=match):
        fused_ingest.encode_groups_fused(td, ("diffuse", "glossy"), out=make())


def test_group_encode_refuses_unknown_names_and_mixed_inputs():
    td = _torch(_raw_passes((8, 8)))
    with pytest.raises(KeyError, match="unknown aux"):
        fused_ingest.encode_groups_fused(td, GROUPS, aux=("normal", "emission"))
    with pytest.raises(ValueError, match="twice"):
        fused_ingest.encode_groups_fused(td, GROUPS, aux=("depth", "depth"))
    with pytest.raises(KeyError, match="light group"):
        fused_ingest.encode_groups_fused(td, ("diffuse", "volume"))
    with pytest.raises(ValueError, match="no light group"):
        fused_ingest.encode_groups_fused(td, ())
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.encode_groups_fused({**td, "depth": td["depth"].double()}, GROUPS)
    with pytest.raises(ValueError, match="want"):
        fused_ingest.encode_groups_fused({**td, "glossy_color": td["glossy_color"][:4]}, GROUPS)
    with pytest.raises(ValueError, match="HWC or NHWC"):
        fused_ingest.encode_groups_fused({k: v[0] for k, v in td.items()}, GROUPS)
    with pytest.raises(ValueError, match="tensors on"):
        fused_ingest.encode_groups_fused({**td, "alpha": td["alpha"].to("meta")}, GROUPS)
    with pytest.raises(ValueError, match="out on"):
        fused_ingest.encode_groups_fused(td, GROUPS, out=torch.empty((4, 8, 8, 14), device="meta"))


def test_group_kernel_entry_refuses_cpu_tensors():
    td = _torch(_raw_passes((8, 8)))
    fused_ingest.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fused_ingest.launch_group_cuda(td, GROUPS)
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.launch_group_cuda({k: v.half() for k, v in td.items()}, GROUPS)
    assert sum(fused_ingest.launches.values()) == 0
    assert set(fused_ingest.launches) == {"radiance", "normal", "depth_alpha", "depth", "alpha",
                                          "group_encode"}


@pytest.mark.parametrize("channels", range(9, 15))
def test_tile_is_a_whole_number_of_float4s(channels):
    """Group g's tile t starts at float (g * pixels + t * P) * C of the
    stack: with P * C a multiple of 4 the tiles of one group keep the
    alignment of the group's first float."""
    p = fused_ingest.group_tile_pixels(channels)
    assert p == fused_ingest.GROUP_TILE_PIXELS and p % 4 == 0
    assert (p * channels * 4) % 16 == 0
    assert (p * 3 * 4) % 16 == 0 and (p * 4) % 16 == 0  # the input tiles, 3 and 1 channels
    assert p * 3 // 4 <= 256  # one float4 of a 3-channel pass per lane of a 256-thread block
    src = (REPO / "deepdenoiser_tpu_torch" / "csrc" / "fused_ingest.cu").read_text()
    assert f"constexpr int TILE_PIXELS = {p};" in src
    assert f"constexpr int MAX_GROUPS = {fused_ingest.GROUP_CAPACITY};" in src
    assert "static_assert((TILE_PIXELS * C * 4) % 16 == 0" in src


def test_tile_helper_refuses_channel_counts_outside_the_stack():
    with pytest.raises(ValueError, match="tile"):
        fused_ingest.group_tile_pixels(8)


@pytest.mark.parametrize("aux,want", [
    ((), {}), (("alpha",), {"alpha": 9}), (("normal", "depth"), {"normal": 9, "depth": 12}),
    (("normal", "depth", "alpha"), {"normal": 9, "depth": 12, "alpha": 13}),
    (("alpha", "depth", "normal"), {"alpha": 9, "depth": 10, "normal": 11}),
], ids=str)
def test_aux_offsets_follow_the_callers_order(aux, want):
    assert fused_ingest._aux_offsets(aux) == want
    assert 9 + sum(passes.channels(a) for a in want) == transforms.group_input_channels(aux)


def test_group_argument_list_matches_the_c_entry_point():
    """ctypes passes what argtypes say; a list that disagrees with the CUDA
    source's signature would corrupt the call on the card, and a pointer
    passed as a 32-bit int is cut silently."""
    src = (REPO / "deepdenoiser_tpu_torch" / "csrc" / "fused_ingest.cu").read_text()
    m = re.search(r'extern "C" int ' + fused_ingest._GROUP_ENTRY + r"\((.*?)\)\s*\{", src, re.S)
    assert m, fused_ingest._GROUP_ENTRY
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctype = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    kinds = ["ptr" if "*" in p else p.rsplit(" ", 1)[0] for p in params]
    assert [ctype[k] for k in kinds] == list(fused_ingest._GROUP_ARGTYPES), params
    names = [p.rsplit(" ", 1)[1].lstrip("*") for p in params]
    assert names == ["group_ptrs", "groups", "normal", "depth", "alpha", "out", "npix",
                     "off_normal", "off_depth", "off_alpha", "eps", "stream"]
    # the aux pointers and offsets go in passes.AUX_PASSES order, as the wrapper sends them
    assert tuple(names[2:5]) == passes.AUX_PASSES
    assert tuple(n.removeprefix("off_") for n in names[7:10]) == passes.AUX_PASSES


def test_the_five_bodies_are_the_single_definition_of_the_arithmetic():
    """Every launcher of the source runs the same five bodies, and the
    source has one build: no conditional compilation, so the kernels the
    tests hold are the kernels a frame runs."""
    src = (REPO / "deepdenoiser_tpu_torch" / "csrc" / "fused_ingest.cu").read_text()
    code = "\n".join(line.split("//", 1)[0] for line in src.splitlines())
    for op in ("RadianceOp", "NormalOp", "DepthAlphaOp", "DepthOp", "AlphaOp"):
        assert len(re.findall(rf"\bstruct {op}\b", code)) == 1, op
    bodies = code[code.index("struct RadianceOp"):code.index("template <class Op, class Index>")]
    for fn in ("log1pf(", "fminf(", "fmaxf("):
        assert code.count(fn) == bodies.count(fn) > 0, fn  # no arithmetic outside the bodies
    assert not re.search(r"^\s*#\s*(if|ifdef|ifndef|define)\b", code, re.M)
