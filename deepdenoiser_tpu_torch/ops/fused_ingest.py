"""Fused ingest: the wrappers of csrc/fused_ingest.cu.

Replaces the five TPU kernels of deepdenoiser_tpu/ops/fused_ingest.py
(_radiance_kernel, _aux_kernel, _depth_alpha_kernel, _depth_kernel,
_alpha_kernel) and their assembler encode_group_inputs_pallas. All are
memory-bound elementwise passes; the design note is in the CUDA source.

The public functions keep the JAX names and take HWC or NHWC fp32 tensors:

    encode_radiance(direct, indirect, color) -> (enc_direct, enc_indirect)
    encode_normal(normal), encode_depth(depth), encode_alpha(alpha)
    encode_depth_alpha(depth, alpha) -> (enc_depth, enc_alpha)
    encode_group_inputs_fused(pass_dict, group, aux) -> (..., H, W, 9 + aux)
    encode_groups_fused(pass_dict, groups, aux) -> (G, ..., H, W, 9 + aux)
    encode_joint_plane(pass_dict, grid, groups, aux) -> the padded plane

encode_joint_plane is the joint frame's input on the card: one launch of
fused_joint_encode_f32 writes the whole padded plane, border included,
that inference/tiled.pad_plane makes of transforms.encode_joint_inputs.
It replaces no TPU kernel (the JAX joint encode is plain XLA).
encode_groups_fused is what the group frame calls when
InferenceConfig.use_pallas_ingest is set: one launch of the whole-pixel
kernel (fused_group_encode_f32) encodes every light group into the
network's input batch, running the five kernel bodies inside it.
encode_group_inputs_fused is its one-group case. The per-pass functions
launch one body each; they return fresh tensors, or with `out=` write into
views the caller gives, channel ranges of a wider tensor included
(encode_group_inputs_per_pass assembles a group's input that way, launch
for launch as the TPU assembler does).

Tensors on the CPU go to the plain versions below (the per-pass
transforms.normalize / demodulate, transforms.encode_group_inputs) and
count no launch; tensors on the card launch the kernel or raise — there is
no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.ops import _build

Tensor = torch.Tensor

# kernel name -> (C entry point, inputs, outputs, takes eps)
_KERNELS = {
    "radiance": ("fused_radiance_f32", 3, 2, True),
    "normal": ("fused_normal_f32", 1, 1, False),
    "depth_alpha": ("fused_depth_alpha_f32", 2, 2, False),
    "depth": ("fused_depth_f32", 1, 1, False),
    "alpha": ("fused_alpha_f32", 1, 1, False),
}

# The whole-pixel group encode. Its C argument list, in order: the host
# array of 3 pointers per group, the group count, normal, depth, alpha (null
# where the aux set leaves one out), out, pixels, the first channel of
# normal, depth and alpha within a pixel, eps, the stream.
_GROUP_ENTRY = "fused_group_encode_f32"
_GROUP_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
)
GROUP_CAPACITY = 8  # groups per launch (MAX_GROUPS of the CUDA source)
GROUP_TILE_PIXELS = 256  # pixels per block (TILE_PIXELS of the CUDA source)

# The joint encode into the padded plane. Its C argument list, in order:
# the host array of 3 pointers per group, the group count, normal, depth,
# alpha (null where the aux set leaves one out), out, the frame's height
# and width, the pads top, bottom, left, right, reflect (1) or replicate
# (0), the first channel of normal, depth and alpha within a pixel, eps,
# the stream.
_JOINT_ENTRY = "fused_joint_encode_f32"
_JOINT_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
)
JOINT_CAPACITY = len(passes.LIGHT_GROUPS)  # groups per launch (MAX_JOINT_GROUPS)

# Launches of each CUDA entry point since the last reset (plain counts; a
# wrapper adds one where it launches and nowhere else). "group_encode"
# counts fused_group_encode_f32, the others the per-pass entry points.
launches: Dict[str, int] = {name: 0 for name in (*_KERNELS, "group_encode")}
# Launches of fused_joint_encode_f32 since the last reset (a plain int, so
# that a reader of plain counts finds it).
joint_encode_launches = 0

_fns: Dict[str, object] = {}


def reset_launches() -> None:
    global joint_encode_launches
    for name in launches:
        launches[name] = 0
    joint_encode_launches = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        symbol, n_in, n_out, has_eps = _KERNELS[name]
        fn = getattr(_build.load("fused_ingest"), symbol)
        n = n_in + n_out
        fn.argtypes = (
            [ctypes.c_void_p] * n + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_longlong] * (2 * n)
            + ([ctypes.c_float] if has_eps else []) + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _entry(symbol: str, argtypes: Sequence) -> object:
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load("fused_ingest"), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


# --------------------------------------------------------------------------
# plain versions (CPU tensors; the card's yardstick in tests/test_torch_gpu.py)
# --------------------------------------------------------------------------


def encode_radiance_plain(direct: Tensor, indirect: Tensor, color: Tensor) -> Tuple[Tensor, Tensor]:
    return (
        transforms.normalize("diffuse_direct", transforms.demodulate(direct, color)),
        transforms.normalize("diffuse_indirect", transforms.demodulate(indirect, color)),
    )


def encode_normal_plain(normal: Tensor) -> Tensor:
    return transforms.normalize("normal", normal)


def encode_depth_plain(depth: Tensor) -> Tensor:
    return transforms.normalize("depth", depth)


def encode_alpha_plain(alpha: Tensor) -> Tensor:
    return transforms.normalize("alpha", alpha)


def encode_depth_alpha_plain(depth: Tensor, alpha: Tensor) -> Tuple[Tensor, Tensor]:
    return encode_depth_plain(depth), encode_alpha_plain(alpha)


_PLAIN = {
    "radiance": encode_radiance_plain,
    "normal": lambda x: (encode_normal_plain(x),),
    "depth_alpha": encode_depth_alpha_plain,
    "depth": lambda x: (encode_depth_plain(x),),
    "alpha": lambda x: (encode_alpha_plain(x),),
}


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------


def _pixel_view(t: Tensor) -> Optional[Tuple[int, int]]:
    """(pixel stride, channel stride) in elements if the (..., C) tensor is
    a uniform (pixels, C) view — its leading dims collapse to one stride —
    else None. A dense tensor gives (C, 1); a channel range of a wider
    stack gives (the stack's channel count, 1)."""
    c = t.shape[-1]
    cs = t.stride(-1) if c > 1 else 1
    dims = [(s, st) for s, st in zip(t.shape[:-1], t.stride()[:-1]) if s > 1]
    if cs < 0 or any(st < 0 for _, st in dims):
        return None
    for (_, st_outer), (s_inner, st_inner) in zip(dims, dims[1:]):
        if st_outer != st_inner * s_inner:
            return None
    return (dims[-1][1] if dims else c * cs), cs


def _check(name: str, tensors: Sequence[Tensor], what: str) -> None:
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_ingest.{name}: fp32 only, got {t.dtype} for an {what}")
        if t.device != first.device:
            raise ValueError(f"fused_ingest.{name}: tensors on {first.device} and {t.device}")
        if tuple(t.shape) != tuple(first.shape):
            raise ValueError(
                f"fused_ingest.{name}: shapes {tuple(first.shape)} and {tuple(t.shape)} differ"
            )


def _run(name: str, inputs: Sequence[Tensor], out: Optional[Sequence[Tensor]],
         plain_on_cpu: bool = True) -> Tuple[Tensor, ...]:
    """Plain version for CPU tensors, the CUDA kernel for tensors on the
    card. `out`: one view per output to write into, else fresh tensors."""
    n_out = _KERNELS[name][2]
    _check(name, inputs, "input")
    first = inputs[0]
    if first.dim() not in (3, 4):
        raise ValueError(f"fused_ingest.{name}: HWC or NHWC, got {tuple(first.shape)}")
    if out is not None:
        out = tuple(out)
        if len(out) != n_out:
            raise ValueError(f"fused_ingest.{name}: {n_out} output view(s), got {len(out)}")
        _check(name, (first, *out), "output")
    if first.device.type == "cpu" and plain_on_cpu:
        res = _PLAIN[name](*inputs)
        if out is None:
            return tuple(res)
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    return _launch(name, inputs, out)


def _launch(name: str, inputs: Sequence[Tensor], out: Optional[Tuple[Tensor, ...]]) -> Tuple[Tensor, ...]:
    _, _, n_out, has_eps = _KERNELS[name]
    first = inputs[0]
    if first.device.type != "cuda":
        raise ValueError(f"fused_ingest.{name}: tensors on {first.device}, need a CUDA device")
    c = first.shape[-1]
    ins, in_strides = [], []
    for t in inputs:
        pv = _pixel_view(t)
        if pv is None:  # rows or columns sliced: one dense copy of this input
            t = t.contiguous()
            pv = (c, 1)
        ins.append(t)
        in_strides.append(pv)
    if out is None:
        out = tuple(torch.empty_like(first, memory_format=torch.contiguous_format)
                    for _ in range(n_out))
    out_strides = []
    for o in out:
        pv = _pixel_view(o)
        if pv is None or pv[1] < 1 or pv[0] < c * pv[1]:
            raise ValueError(
                f"fused_ingest.{name}: output view with strides {o.stride()} is not a "
                "uniform (pixels, channels) view"
            )
        out_strides.append(pv)
    if first.numel() == 0:
        return out
    args = [t.data_ptr() for t in (*ins, *out)]
    args += [first.numel() // c, c]
    for ps, cs in (*in_strides, *out_strides):
        args += [ps, cs]
    if has_eps:
        args.append(transforms.DEMOD_EPS)
    with torch.cuda.device(first.device):
        args.append(torch.cuda.current_stream(first.device).cuda_stream)
        err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"fused_ingest.{name}: kernel launch failed with cudaError {err}")
    launches[name] += 1
    return out


# --------------------------------------------------------------------------
# public functions (the JAX names)
# --------------------------------------------------------------------------


def encode_radiance(direct: Tensor, indirect: Tensor, color: Tensor,
                    out: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, Tensor]:
    """log1p(demod(direct)), log1p(demod(indirect)) in one pass."""
    return _run("radiance", (direct, indirect, color), out)


def encode_normal(normal: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _run("normal", (normal,), None if out is None else (out,))[0]


def encode_depth_alpha(depth: Tensor, alpha: Tensor,
                       out: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, Tensor]:
    return _run("depth_alpha", (depth, alpha), out)


def encode_depth(depth: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _run("depth", (depth,), None if out is None else (out,))[0]


def encode_alpha(alpha: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _run("alpha", (alpha,), None if out is None else (out,))[0]


def launch_cuda(name: str, *inputs: Tensor) -> Tuple[Tensor, ...]:
    """The kernel entry itself: launch kernel `name` ('radiance', 'normal',
    'depth_alpha', 'depth', 'alpha') on CUDA tensors; CPU tensors and other
    dtypes raise."""
    return _run(name, inputs, None, plain_on_cpu=False)


def group_tile_pixels(channels: int) -> int:
    """Pixels in one block's tile of a (groups, pixels, channels) stack. A
    tile is copied out as float4s, so its byte size must be a multiple of
    16 for every channel count the aux subsets give (9 to 14)."""
    if channels < 9 or (GROUP_TILE_PIXELS * channels * 4) % 16:
        raise ValueError(f"no float4 tile for {channels} channels")
    return GROUP_TILE_PIXELS


def _aux_offsets(aux: Sequence[str], first: int = 9) -> Dict[str, int]:
    """First channel of each aux pass within a pixel, in the caller's order,
    the first at channel `first`."""
    at, ch = {}, first
    for a in aux:
        if a not in passes.AUX_PASSES:
            raise KeyError(f"unknown aux pass {a!r}")
        if a in at:
            raise ValueError(f"aux pass {a!r} given twice")
        at[a] = ch
        ch += passes.channels(a)
    return at


def _dense16(t: Tensor) -> Tensor:
    """`t` itself if dense and 16-byte aligned, else one dense copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_group_cuda(
    pass_dict: Mapping[str, Tensor],
    groups: Sequence[str],
    aux: Sequence[str] = passes.AUX_PASSES,
    out: Optional[Tensor] = None,
) -> Tensor:
    """The group-encode kernel entry itself: encode_groups_fused for CUDA
    tensors; CPU tensors raise."""
    return encode_groups_fused(pass_dict, groups, aux, out, _plain_on_cpu=False)


def encode_groups_fused(
    pass_dict: Mapping[str, Tensor],
    groups: Sequence[str],
    aux: Sequence[str] = passes.AUX_PASSES,
    out: Optional[Tensor] = None,
    _plain_on_cpu: bool = True,
) -> Tensor:
    """Every group's network input, (G, ..., H, W, 9 + aux channels): per
    group [log1p(demod direct), log1p(demod indirect), albedo, encoded
    aux...] along channels, unscaled, as transforms.encode_group_inputs
    gives them stacked. On the card one launch writes whole pixels of every
    group and reads the shared aux passes once (more launches past
    GROUP_CAPACITY groups).

    fp32 HWC or NHWC passes on one device and of one (..., H, W). `out`: a
    contiguous, 16-byte-aligned tensor of the result's shape to write into,
    else a fresh one is made; any other `out` raises. An unknown aux name
    or light group is a KeyError."""
    name = "encode_groups_fused"
    groups = tuple(groups)
    if not groups:
        raise ValueError(f"fused_ingest.{name}: no light group given")
    at = _aux_offsets(aux)
    named = [(p, 3) for g in groups for p in passes.group_passes(g)]
    named += [(a, passes.channels(a)) for a in at]
    first = pass_dict[named[0][0]]
    lead = tuple(first.shape[:-1])
    if first.dim() not in (3, 4):
        raise ValueError(f"fused_ingest.{name}: HWC or NHWC, got {tuple(first.shape)}")
    for p, c in named:
        t = pass_dict[p]
        if t.dtype != torch.float32:
            raise TypeError(f"fused_ingest.{name}: fp32 only, got {t.dtype} for {p!r}")
        if t.device != first.device:
            raise ValueError(f"fused_ingest.{name}: tensors on {first.device} and {t.device}")
        if tuple(t.shape) != (*lead, c):
            raise ValueError(
                f"fused_ingest.{name}: {p!r} is {tuple(t.shape)}, want {(*lead, c)}")
    n_ch = transforms.group_input_channels(tuple(at))
    shape = (len(groups), *lead, n_ch)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=first.device)
    else:
        if out.dtype != torch.float32:
            raise TypeError(f"fused_ingest.{name}: fp32 only, got {out.dtype} for out")
        if out.device != first.device:
            raise ValueError(f"fused_ingest.{name}: out on {out.device}, passes on {first.device}")
        if tuple(out.shape) != shape:
            raise ValueError(f"fused_ingest.{name}: out {tuple(out.shape)} != {shape}")
        if not out.is_contiguous() or out.data_ptr() % 16:
            raise ValueError(
                f"fused_ingest.{name}: out must be contiguous and 16-byte aligned; got strides "
                f"{out.stride()} for shape {shape}, address % 16 = {out.data_ptr() % 16}")
    if first.device.type == "cpu" and _plain_on_cpu:
        plain = torch.stack([transforms.encode_group_inputs(pass_dict, g, tuple(at))
                             for g in groups], 0)
        return out.copy_(plain)
    if first.device.type != "cuda":
        raise ValueError(f"fused_ingest.{name}: tensors on {first.device}, need a CUDA device")
    npix = first.numel() // 3
    if npix == 0:
        return out
    group_tile_pixels(n_ch)
    aux_t = {a: _dense16(pass_dict[a]) for a in at}
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        for g0 in range(0, len(groups), GROUP_CAPACITY):
            chunk = groups[g0 : g0 + GROUP_CAPACITY]
            ins = [_dense16(pass_dict[p]) for g in chunk for p in passes.group_passes(g)]
            ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
            err = _entry(_GROUP_ENTRY, _GROUP_ARGTYPES)(
                ptrs, len(chunk),
                *(aux_t[a].data_ptr() if a in at else None for a in passes.AUX_PASSES),
                out[g0].data_ptr(), npix,
                *(at.get(a, -1) for a in passes.AUX_PASSES),
                transforms.DEMOD_EPS, stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"fused_ingest.{name}: kernel launch failed with cudaError {err}")
            launches["group_encode"] += 1
    return out


def encode_group_inputs_fused(
    pass_dict: Mapping[str, Tensor],
    group: str,
    aux: Sequence[str] = passes.AUX_PASSES,
    out: Optional[Tensor] = None,
) -> Tensor:
    """The fused twin of transforms.encode_group_inputs (unscaled):
    [log1p(demod direct), log1p(demod indirect), albedo, encoded aux...]
    along channels, written by the one-group case of encode_groups_fused's
    launch into `out` (contiguous, 16-byte aligned) or a fresh tensor, so
    nothing is concatenated. An unknown aux name is a KeyError."""
    return encode_groups_fused(pass_dict, (group,), aux,
                               None if out is None else out.unsqueeze(0))[0]


def encode_group_inputs_per_pass(
    pass_dict: Mapping[str, Tensor],
    group: str,
    aux: Sequence[str] = passes.AUX_PASSES,
    out: Optional[Tensor] = None,
) -> Tensor:
    """The same result through the per-pass kernels, launch for launch as
    encode_group_inputs_pallas makes them: each writes its channel range of
    the result (`out`, which may itself be a view, or a fresh tensor).
    Depth and alpha share one launch only when both are asked for; either
    alone takes its own kernel."""
    d_name, i_name, c_name = passes.group_passes(group)
    albedo = pass_dict[c_name]
    at = {a: slice(ch, ch + passes.channels(a)) for a, ch in _aux_offsets(aux).items()}
    shape = (*albedo.shape[:-1], transforms.group_input_channels(tuple(at)))
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=albedo.device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"encode_group_inputs_per_pass: out {tuple(out.shape)} != {shape}")
    encode_radiance(pass_dict[d_name], pass_dict[i_name], albedo,
                    out=(out[..., 0:3], out[..., 3:6]))
    out[..., 6:9].copy_(albedo)
    if "normal" in at:
        encode_normal(pass_dict["normal"], out=out[..., at["normal"]])
    if "depth" in at and "alpha" in at:
        encode_depth_alpha(pass_dict["depth"], pass_dict["alpha"],
                           out=(out[..., at["depth"]], out[..., at["alpha"]]))
    elif "depth" in at:
        encode_depth(pass_dict["depth"], out=out[..., at["depth"]])
    elif "alpha" in at:
        encode_alpha(pass_dict["alpha"], out=out[..., at["alpha"]])
    return out


def encode_joint_plane(
    pass_dict: Mapping[str, Tensor],
    grid: tiled.TileGrid,
    groups: Sequence[str] = passes.LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
) -> Tensor:
    """The joint frame's padded plane, (PH + 2hp, PW + 2hp, 9 * groups + aux
    channels) fp32: tiled.pad_plane(transforms.encode_joint_inputs(pass_dict,
    groups, aux), grid), unscaled. On the card one launch of the joint
    encode kernel reads each pass once and writes the plane, its border
    included, equal to that chain bit for bit (NaN passed on as its clamps
    pass it on); on the CPU the chain itself runs.

    fp32 (H, W, C) passes on one device, (H, W) the grid's frame. An
    unknown aux name or light group is a KeyError."""
    return _joint_plane(pass_dict, grid, groups, aux, plain_on_cpu=True)


def launch_joint_cuda(
    pass_dict: Mapping[str, Tensor],
    grid: tiled.TileGrid,
    groups: Sequence[str] = passes.LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
) -> Tensor:
    """The joint-encode kernel entry itself: encode_joint_plane for CUDA
    tensors; CPU tensors raise."""
    return _joint_plane(pass_dict, grid, groups, aux, plain_on_cpu=False)


def _joint_plane(pass_dict: Mapping[str, Tensor], grid: tiled.TileGrid, groups: Sequence[str],
                 aux: Sequence[str], plain_on_cpu: bool) -> Tensor:
    global joint_encode_launches
    name = "encode_joint_plane"
    groups = tuple(groups)
    if not groups or len(groups) > JOINT_CAPACITY:
        raise ValueError(f"fused_ingest.{name}: 1 to {JOINT_CAPACITY} light groups, "
                         f"got {len(groups)}")
    at = _aux_offsets(aux, 9 * len(groups))
    named = [(p, 3) for g in groups for p in passes.group_passes(g)]
    named += [(a, passes.channels(a)) for a in at]
    first = pass_dict[named[0][0]]
    for p, c in named:
        t = pass_dict[p]
        if t.dtype != torch.float32:
            raise TypeError(f"fused_ingest.{name}: fp32 only, got {t.dtype} for {p!r}")
        if t.device != first.device:
            raise ValueError(f"fused_ingest.{name}: tensors on {first.device} and {t.device}")
        if tuple(t.shape) != (grid.height, grid.width, c):
            raise ValueError(f"fused_ingest.{name}: {p!r} is {tuple(t.shape)}, "
                             f"want {(grid.height, grid.width, c)}")
    if first.device.type == "cpu" and plain_on_cpu:
        return tiled.pad_plane(transforms.encode_joint_inputs(pass_dict, groups, tuple(at)), grid)
    if first.device.type != "cuda":
        raise ValueError(f"fused_ingest.{name}: tensors on {first.device}, need a CUDA device")
    top, bottom, left, right, mode = tiled.plane_pads(grid)
    out = torch.empty((*tiled.plane_hw(grid), transforms.joint_input_channels(groups, tuple(at))),
                      dtype=torch.float32, device=first.device)
    ins = [pass_dict[p].contiguous() for g in groups for p in passes.group_passes(g)]
    aux_t = {a: pass_dict[a].contiguous() for a in at}
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    with torch.cuda.device(first.device):
        err = _entry(_JOINT_ENTRY, _JOINT_ARGTYPES)(
            ptrs, len(groups),
            *(aux_t[a].data_ptr() if a in at else None for a in passes.AUX_PASSES),
            out.data_ptr(), grid.height, grid.width, top, bottom, left, right,
            int(mode == "reflect"), *(at.get(a, -1) for a in passes.AUX_PASSES),
            transforms.DEMOD_EPS, torch.cuda.current_stream(first.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ingest.{name}: kernel launch failed with cudaError {err}")
    joint_encode_launches += 1
    return out
