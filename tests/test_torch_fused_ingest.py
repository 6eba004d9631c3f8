"""The port's fused ingest (ops/fused_ingest.py) against the JAX package's.

On the CPU the port's wrappers run their plain versions, so these tests hold
the plain versions: against the Pallas kernels in interpret mode (as
tests/test_pallas.py runs them), against the JAX transforms and against the
port's own per-pass normalize / demodulate, on the same numpy inputs. Inputs
reach every clamp: negative radiance, albedo 0, normals beyond [-1, 1], alpha
outside [0, 1], negative depth. Tolerances: atol 1e-6 (log1p, division),
1e-7 for the pure clamps. The CUDA kernels themselves are held to the plain
versions on the card by tests/test_torch_gpu.py; here the launcher's Python
side (views, strides, refusals, argument lists) is checked.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu.inference import tiled as jtiled
from deepdenoiser_tpu.ops import fused_ingest as jfused
from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.ops import fused_ingest

REPO = Path(__file__).resolve().parents[1]
NAMES = ["radiance", "normal", "depth_alpha", "depth", "alpha"]
AUX_SUBSETS = [(), ("depth",), ("alpha",), ("normal", "depth"), ("normal", "depth", "alpha")]
ATOL = {"radiance": 1e-6, "normal": 1e-7, "depth_alpha": 1e-6, "depth": 1e-6, "alpha": 1e-7}


def _raw_passes(lead, seed=0, groups=("diffuse", "glossy")):
    rng = np.random.default_rng(seed)

    def rand(c, lo, hi):
        return (lo + (hi - lo) * rng.random((*lead, c))).astype(np.float32)

    pd = {"normal": rand(3, -1.5, 1.5), "depth": rand(1, -2.0, 30.0), "alpha": rand(1, -0.5, 1.5)}
    for grp in groups:
        pd[f"{grp}_direct"] = rand(3, -1.0, 20.0)
        pd[f"{grp}_indirect"] = rand(3, -1.0, 5.0)
        pd[f"{grp}_color"] = np.maximum(rand(3, -0.2, 1.0), 0.0)  # a fifth exactly 0
    return pd


def _inputs(name, pd):
    return {
        "radiance": (pd["diffuse_direct"], pd["diffuse_indirect"], pd["diffuse_color"]),
        "normal": (pd["normal"],), "depth_alpha": (pd["depth"], pd["alpha"]),
        "depth": (pd["depth"],), "alpha": (pd["alpha"],),
    }[name]


PUBLIC = {
    "radiance": (fused_ingest.encode_radiance, jfused.encode_radiance),
    "normal": (fused_ingest.encode_normal, jfused.encode_normal),
    "depth_alpha": (fused_ingest.encode_depth_alpha, jfused.encode_depth_alpha),
    "depth": (fused_ingest.encode_depth, jfused.encode_depth),
    "alpha": (fused_ingest.encode_alpha, jfused.encode_alpha),
}


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("lead", [(24, 40), (2, 24, 40), (7, 9)], ids=["hwc", "nhwc", "ragged"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(name, lead):
    pd = _raw_passes(lead, seed=len(lead))
    ours, theirs = PUBLIC[name]
    arrays = _inputs(name, pd)
    fused_ingest.reset_launches()
    got = _tuple(ours(*(torch.from_numpy(a) for a in arrays)))
    assert sum(fused_ingest.launches.values()) == 0  # CPU tensors launch nothing
    want = _tuple(theirs(*(jnp.asarray(a) for a in arrays), interpret=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL[name], rtol=0)


@pytest.mark.parametrize("lead", [(24, 40), (2, 24, 40)], ids=["hwc", "nhwc"])
def test_plain_versions_are_the_per_pass_transforms(lead):
    pd = {k: torch.from_numpy(v) for k, v in _raw_passes(lead, seed=11).items()}
    d, i, c = pd["glossy_direct"], pd["glossy_indirect"], pd["glossy_color"]
    got_d, got_i = fused_ingest.encode_radiance(d, i, c)
    torch.testing.assert_close(
        got_d, transforms.normalize("glossy_direct", transforms.demodulate(d, c)), atol=0, rtol=0)
    torch.testing.assert_close(
        got_i, transforms.normalize("glossy_indirect", transforms.demodulate(i, c)), atol=0, rtol=0)
    for name, fn in [("normal", fused_ingest.encode_normal), ("depth", fused_ingest.encode_depth),
                     ("alpha", fused_ingest.encode_alpha)]:
        torch.testing.assert_close(fn(pd[name]), transforms.normalize(name, pd[name]),
                                   atol=0, rtol=0)
    dep, alp = fused_ingest.encode_depth_alpha(pd["depth"], pd["alpha"])
    torch.testing.assert_close(dep, transforms.normalize("depth", pd["depth"]), atol=0, rtol=0)
    torch.testing.assert_close(alp, transforms.normalize("alpha", pd["alpha"]), atol=0, rtol=0)
    # and every clamp was reached
    assert float(got_d.min()) == 0.0 and float(alp.min()) == 0.0 and float(alp.max()) == 1.0
    assert float(dep.min()) == 0.0 and float(fused_ingest.encode_normal(pd["normal"]).max()) == 1.0


@pytest.mark.parametrize("lead", [(24, 40), (2, 24, 40)], ids=["hwc", "nhwc"])
@pytest.mark.parametrize("aux", AUX_SUBSETS, ids=str)
def test_group_encode_matches_jax_for_every_aux_subset(aux, lead):
    pd = _raw_passes(lead, seed=3)
    if "alpha" not in aux:
        del pd["alpha"]  # a subset must not reach for passes it was not asked for
    jd = {k: jnp.asarray(v) for k, v in pd.items()}
    td = {k: torch.from_numpy(v) for k, v in pd.items()}
    fused_ingest.reset_launches()
    got = fused_ingest.encode_group_inputs_fused(td, "diffuse", aux)
    assert sum(fused_ingest.launches.values()) == 0
    want_pallas = jfused.encode_group_inputs_pallas(jd, "diffuse", aux=aux, interpret=True)
    want_jax = jtransforms.encode_group_inputs(jd, "diffuse", aux=aux)
    assert tuple(got.shape) == want_jax.shape == (*lead, transforms.group_input_channels(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), atol=1e-6, rtol=0)
    torch.testing.assert_close(got, transforms.encode_group_inputs(td, "diffuse", aux),
                               atol=0, rtol=0)


def test_group_encode_writes_into_a_given_stack():
    """The group frame hands each group a slice of one (G, H, W, 14) batch."""
    td = {k: torch.from_numpy(v) for k, v in _raw_passes((12, 20), seed=4).items()}
    stack = torch.full((2, 12, 20, 14), -7.0)
    ret = fused_ingest.encode_group_inputs_fused(td, "glossy", out=stack[1])
    assert ret.data_ptr() == stack[1].data_ptr()
    torch.testing.assert_close(stack[1], transforms.encode_group_inputs(td, "glossy"),
                               atol=0, rtol=0)
    assert bool((stack[0] == -7.0).all())
    with pytest.raises(ValueError, match="out"):
        fused_ingest.encode_group_inputs_fused(td, "glossy", aux=("depth",), out=stack[1])


def test_group_encode_refuses_unknown_aux_and_groups():
    td = {k: torch.from_numpy(v) for k, v in _raw_passes((8, 8)).items()}
    with pytest.raises(KeyError, match="unknown aux"):
        fused_ingest.encode_group_inputs_fused(td, "diffuse", aux=("normal", "emission"))
    with pytest.raises(KeyError, match="light group"):
        fused_ingest.encode_group_inputs_fused(td, "volume")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_entry_refuses_cpu_tensors_and_other_dtypes(name):
    arrays = [torch.from_numpy(a) for a in _inputs(name, _raw_passes((8, 8)))]
    fused_ingest.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fused_ingest.launch_cuda(name, *arrays)
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.launch_cuda(name, *(a.double() for a in arrays))
    with pytest.raises(TypeError, match="fp32"):
        PUBLIC[name][0](*(a.to(torch.bfloat16) for a in arrays))
    with pytest.raises(ValueError, match="HWC or NHWC"):
        PUBLIC[name][0](*(a[0] for a in arrays))
    assert sum(fused_ingest.launches.values()) == 0


def test_mismatched_shapes_and_output_counts_raise():
    x = torch.zeros((8, 8, 3))
    with pytest.raises(ValueError, match="differ"):
        fused_ingest.encode_radiance(x, x, torch.zeros((8, 9, 3)))
    with pytest.raises(ValueError, match="output view"):
        fused_ingest.encode_radiance(x, x, x, out=(torch.empty_like(x),))
    with pytest.raises(ValueError, match="differ"):
        fused_ingest.encode_normal(x, out=torch.empty((8, 8, 4)))


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros((6, 10, 3)), (3, 1)),
    (lambda: torch.zeros((2, 6, 10, 3)), (3, 1)),
    (lambda: torch.zeros((2, 6, 10, 14))[..., 9:12], (14, 1)),
    (lambda: torch.zeros((2, 6, 10, 14))[1, :, :, 12:13], (14, 1)),
    (lambda: torch.zeros((6, 10, 1)), (1, 1)),
    (lambda: torch.zeros((1, 6, 1, 3)), (3, 1)),
    (lambda: torch.zeros((6, 10, 6))[..., ::2], (6, 2)),
    (lambda: torch.zeros((12, 10, 3))[::2], None),      # rows sliced
    (lambda: torch.zeros((6, 20, 3))[:, 5:15], None),   # columns sliced
    (lambda: torch.zeros((3, 6, 10)).permute(1, 2, 0), (1, 60)),  # planar: still uniform
    (lambda: torch.zeros((6, 1, 3)).expand(6, 10, 3), None),
], ids=["hwc", "nhwc", "channel-range", "one-channel-of-stack", "c1", "unit-dims",
        "channel-stride", "rows-sliced", "cols-sliced", "planar", "broadcast"])
def test_pixel_view_finds_the_uniform_stride_or_refuses(make, want):
    """What the launcher hands the kernel: (pixel stride, channel stride) of a
    (pixels, channels) view, or None where the leading dims do not collapse."""
    assert fused_ingest._pixel_view(make()) == want


@pytest.mark.parametrize("name", NAMES)
def test_argument_list_matches_the_c_entry_point(name):
    """ctypes passes what argtypes say; a count that disagrees with the CUDA
    source's signature would corrupt the call on the card."""
    symbol, n_in, n_out, has_eps = fused_ingest._KERNELS[name]
    src = (REPO / "deepdenoiser_tpu_torch" / "csrc" / "fused_ingest.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src, re.S)
    assert m, symbol
    params = [p.strip() for p in m.group(1).split(",")]
    n = n_in + n_out
    kinds = ["ptr" if "*" in p else p.split()[0] + (" long" if p.startswith("long long") else "")
             for p in params]
    want = ["ptr"] * n + ["long long", "int"] + ["long long"] * (2 * n)
    want += (["float"] if has_eps else []) + ["ptr"]
    assert kinds == want, (symbol, params)
    assert sum("const float*" in p for p in params) == n_in
    assert "-use_fast_math" not in " ".join(fused_ingest._build.NVCC_FLAGS)
    assert "__fdividef" not in src.split("#include")[1]


# (h, w, tile, halo, multiple) of the joint plane cases: the whole frame
# with border 32, a tiled grid whose rounding makes the bottom and right
# pads larger than the halo, and a frame smaller than its pads (replicate)
JOINT_GRIDS = {
    "whole-border-32": ((45, 70, 0, 32, 8), "reflect"),
    "tiled-rounded": ((45, 70, 16, 4, 4), "reflect"),
    "replicate": ((20, 28, 0, 32, 8), "replicate"),
}


@pytest.mark.parametrize("aux", [("normal", "depth", "alpha"), ("alpha", "depth")], ids="+".join)
@pytest.mark.parametrize("case", sorted(JOINT_GRIDS))
def test_joint_plane_plain_form_is_the_padded_joint_encode(case, aux):
    """encode_joint_plane on the CPU is pad_plane(encode_joint_inputs(...))
    exactly, and at fp32 the JAX package's pad_plane of its
    encode_joint_inputs; the plane's border follows tiled.plane_pads."""
    (h, w, tile, halo, multiple), mode = JOINT_GRIDS[case]
    groups = passes.LIGHT_GROUPS
    pd = _raw_passes((h, w), seed=h + len(aux), groups=groups)
    td = {k: torch.from_numpy(v) for k, v in pd.items()}
    grid = tiled.plan_grid(h, w, tile, halo, multiple)
    top, bottom, left, right, got_mode = tiled.plane_pads(grid)
    assert got_mode == mode and (top, left) == (grid.halo, grid.halo)
    if case == "tiled-rounded":
        assert bottom > grid.halo and right > grid.halo
    fused_ingest.reset_launches()
    got = fused_ingest.encode_joint_plane(td, grid, groups, aux)
    assert fused_ingest.joint_encode_launches == 0  # CPU tensors launch nothing
    c = transforms.joint_input_channels(groups, aux)
    assert tuple(got.shape) == (*tiled.plane_hw(grid), c) == (top + h + bottom, left + w + right, c)
    torch.testing.assert_close(
        got, tiled.pad_plane(transforms.encode_joint_inputs(td, groups, aux), grid), atol=0, rtol=0)
    torch.testing.assert_close(got[top : top + h, left : left + w],
                               transforms.encode_joint_inputs(td, groups, aux), atol=0, rtol=0)
    jgrid = jtiled.plan_grid(h, w, tile, halo, multiple)
    want = jtiled.pad_plane(
        jtransforms.encode_joint_inputs({k: jnp.asarray(v) for k, v in pd.items()}, groups, aux),
        jgrid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_joint_kernel_entry_refuses_cpu_tensors_and_other_dtypes():
    groups = passes.LIGHT_GROUPS
    td = {k: torch.from_numpy(v) for k, v in _raw_passes((8, 8), groups=groups).items()}
    grid = tiled.plan_grid(8, 8, 0, 4, 4)
    fused_ingest.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fused_ingest.launch_joint_cuda(td, grid, groups)
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.launch_joint_cuda({k: v.double() for k, v in td.items()}, grid, groups)
    with pytest.raises(TypeError, match="fp32"):
        fused_ingest.encode_joint_plane({k: v.to(torch.bfloat16) for k, v in td.items()}, grid)
    with pytest.raises(ValueError, match="want"):
        fused_ingest.encode_joint_plane(td, tiled.plan_grid(8, 9, 0, 4, 4))
    with pytest.raises(ValueError, match="tensors on"):
        fused_ingest.encode_joint_plane({**td, "depth": td["depth"].to("meta")}, grid)
    with pytest.raises(ValueError, match="light groups"):
        fused_ingest.encode_joint_plane(td, grid, groups + ("diffuse",))
    with pytest.raises(KeyError, match="unknown aux"):
        fused_ingest.encode_joint_plane(td, grid, groups, ("normal", "emission"))
    assert fused_ingest.joint_encode_launches == 0
    assert sum(fused_ingest.launches.values()) == 0


def test_joint_argument_list_matches_the_c_entry_point():
    """ctypes passes what argtypes say; a list that disagrees with the CUDA
    source's signature would corrupt the call on the card, and a pointer
    passed as a 32-bit int is cut silently."""
    src = (REPO / "deepdenoiser_tpu_torch" / "csrc" / "fused_ingest.cu").read_text()
    m = re.search(r'extern "C" int ' + fused_ingest._JOINT_ENTRY + r"\((.*?)\)\s*\{", src, re.S)
    assert m, fused_ingest._JOINT_ENTRY
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctype = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    kinds = ["ptr" if "*" in p else p.rsplit(" ", 1)[0] for p in params]
    assert [ctype[k] for k in kinds] == list(fused_ingest._JOINT_ARGTYPES), params
    names = [p.rsplit(" ", 1)[1].lstrip("*") for p in params]
    assert names == ["group_ptrs", "groups", "normal", "depth", "alpha", "out", "height", "width",
                     "top", "bottom", "left", "right", "reflect", "off_normal", "off_depth",
                     "off_alpha", "eps", "stream"]
    # the aux pointers and offsets go in passes.AUX_PASSES order, as the wrapper sends them
    assert tuple(names[2:5]) == passes.AUX_PASSES
    assert tuple(n.removeprefix("off_") for n in names[13:16]) == passes.AUX_PASSES
    # the pads in the order tiled.plane_pads gives them
    assert names[8:12] == ["top", "bottom", "left", "right"]
    assert f"constexpr int MAX_JOINT_GROUPS = {fused_ingest.JOINT_CAPACITY};" in src
