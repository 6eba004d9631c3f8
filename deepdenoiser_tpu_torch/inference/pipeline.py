"""Full-frame multi-pass denoising pipeline on the card.

The port of deepdenoiser_tpu/inference/pipeline.py:

  joint  encode all light groups into one 41-channel NHWC stack (+ one
         presence plane per group with use_flags) → reflect-pad to the
         padded plane (on the card, one kernel launch writes the padded
         plane) → DenoiserModel over the plane or its tiles → crop or
         stitch → expm1 / remodulate
  group  encode each light group into its own 14-channel stack, all groups
         as one (G, H, W, 14) batch → pad → DenoiserModel over the batch of
         planes or tiles → crop or stitch → decode per group
  rgb    noisy combined + albedo + aux → pad → DenoiserModel → crop or
         stitch → expm1

and, for joint and group, recompose Σ color⊙(direct+indirect) + emission +
environment on the device. InferenceConfig chooses whole-frame (tile=0) or
tiled execution (tile, tile_batch, stitch): inference/tiled.py. With
spatial_shard and a mesh with a 'spatial' axis (parallel/mesh.py), joint
and group frames run band-parallel over the mesh's devices with halo
exchange (parallel/halo.py); spatial_shard without a mesh, and in rgb
mode, runs on one device with the certified halo, as in the JAX package.

PyTorch runs eagerly, so each factory builds the model once, loads the
weights onto the device and returns a callable on a pass dict. The kernels
follow the tensors: on the card the KPN filter apply (ops/kpn_apply.py),
the joint encode into the padded plane and, with
InferenceConfig.use_pallas_ingest, the group encode (ops/fused_ingest.py)
are CUDA kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import passes, tracing, transforms, weights_io
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops import fused_ingest
from deepdenoiser_tpu_torch.parallel import halo as halo_lib

Tensor = torch.Tensor


def plan_for(
    model_cfg: ModelConfig, infer_cfg: InferenceConfig, height: int, width: int
) -> tiled.TileGrid:
    halo = infer_cfg.halo if infer_cfg.halo > 0 else factory.halo(model_cfg)
    if infer_cfg.tile == 0 and not infer_cfg.spatial_shard and infer_cfg.border >= 0:
        # Whole-frame mode: the pad is border context only (no seams to
        # certify), so the smaller reflect border of InferenceConfig.border
        # applies. Tiled plans keep the certified halo.
        halo = min(halo, infer_cfg.border)
    return tiled.plan_grid(
        height, width, infer_cfg.tile, halo, factory.spatial_multiple(model_cfg)
    )


def _to_device(pass_dict: Mapping[str, Any], device: torch.device) -> Dict[str, Tensor]:
    return {
        k: torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in pass_dict.items()
    }


def _with_passthrough(out: Dict[str, Tensor], pd: Mapping[str, Tensor],
                      groups: Sequence[str]) -> Dict[str, Tensor]:
    """Add the passes carried through unchanged and the recomposed frame."""
    for extra in passes.COMPOSITE_EXTRA + ("alpha",):
        if extra in pd:
            out[extra] = pd[extra]
    out["combined"] = transforms.recompose(out, groups)
    return out


def _load_model(model_cfg: ModelConfig, infer_cfg: InferenceConfig, height: int, width: int,
                params: Mapping[str, Any], device, mesh=None,
                ) -> Tuple[factory.DenoiserModel, tiled.TileGrid, torch.device]:
    """What every frame factory shares: resolve the device (the card, or
    raise; with a mesh, the first device of its 'spatial' axis), plan the
    plane, build the model in the inference dtype and load `params` onto
    the device."""
    if infer_cfg.stitch not in ("exact", "feather"):
        raise ValueError(f"stitch must be 'exact' or 'feather', got {infer_cfg.stitch!r}")
    if mesh is not None and infer_cfg.spatial_shard:
        first = mesh.axis_devices("spatial")[0]
        if device is not None and device_lib.resolve(device) != first:
            raise ValueError(f"device {device} is not the mesh's first device {first}")
        device = first
    dev = device_lib.resolve(device)
    grid = plan_for(model_cfg, infer_cfg, height, width)
    model = factory.build_model(
        dataclasses.replace(model_cfg, compute_dtype=infer_cfg.compute_dtype)
    )
    weights_io.load_into(model, params)
    model.to(dev).eval()
    return model, grid, dev


def _frame_fn(model, grid: tiled.TileGrid, infer_cfg: InferenceConfig, out_channels: int,
              batch_dims: int = 0, mesh=None, multiple: int = 1):
    """The plane's network run: band-parallel over `mesh` with
    spatial_shard, else the tile grid."""
    if infer_cfg.spatial_shard and mesh is not None:
        bands = halo_lib.make_spatial_apply_batched(
            model, mesh, grid.height, grid.width, grid.halo, multiple)
        return bands if batch_dims else lambda frame: bands(frame[None])[0]
    return tiled.make_tiled_apply(
        model, grid, out_channels, tile_batch=infer_cfg.tile_batch,
        batch_dims=batch_dims, feather=infer_cfg.stitch == "feather",
    )


class JointFrameDenoiser:
    """{pass_name: (H, W, C)} -> denoised '<g>_direct' / '<g>_indirect' per
    group, the color passes, emission / environment / alpha passed through,
    and 'combined' recomposed — the JAX pipeline's output dict.

    use_flags (flag-conditioned models): a group whose passes are missing
    from the frame is zero-filled, the groups' presence bits go in as
    constant planes after the encoded channels, and the absent groups are
    left out of the outputs and of the recomposition.

    On the card, without scales or flags, and with a frame function that
    runs on a padded plane (the tile grid's; the band-parallel one pads by
    itself), one launch of the joint encode kernel
    (ops/fused_ingest.encode_joint_plane) writes the padded plane and the
    network runs on it; otherwise the plain encode and frame_fn run. Both
    give the same plane bit for bit."""

    def __init__(self, model: factory.DenoiserModel, grid: tiled.TileGrid,
                 groups: Sequence[str], aux: Sequence[str], device: torch.device,
                 scales: Optional[Mapping[str, float]], frame_fn, use_flags: bool = False):
        self.model, self.grid, self.device = model, grid, device
        self.groups, self.aux, self.scales = tuple(groups), tuple(aux), scales
        self.frame_fn, self.use_flags = frame_fn, use_flags
        self.on_plane = _plane_entry(frame_fn, device, scales, use_flags)

    @torch.inference_mode()
    def __call__(self, pass_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
        with tracing.span("frame"):
            given = _to_device(pass_dict, self.device)
            pd = dict(given)
            present = self.groups
            h, w = self.grid.height, self.grid.width
            with tracing.span("encode"):
                if self.on_plane is not None:
                    plane = fused_ingest.encode_joint_plane(pd, self.grid, self.groups, self.aux)
                else:
                    if self.use_flags:
                        present = tuple(g for g in self.groups
                                        if all(nm in given for nm in passes.group_passes(g)))
                        for g in self.groups:
                            if g not in present:
                                for nm in passes.group_passes(g):
                                    pd[nm] = torch.zeros((h, w, 3), dtype=torch.float32,
                                                         device=self.device)
                    enc = transforms.encode_joint_inputs(pd, self.groups, self.aux,
                                                         scales=self.scales)
                    if self.use_flags:
                        bits = torch.tensor([1.0 if g in present else 0.0 for g in self.groups],
                                            dtype=torch.float32, device=self.device)
                        enc = torch.cat((enc, bits.expand(h, w, len(self.groups))), dim=-1)
            with tracing.span("net"):
                dec = self.on_plane(plane) if self.on_plane is not None else self.frame_fn(enc)
            with tracing.span("decode"):
                decoded = transforms.decode_joint_outputs(dec, pd, self.groups, scales=self.scales)
                out: Dict[str, Tensor] = {}
                for g in present:
                    d_name, i_name, c_name = passes.group_passes(g)
                    out[d_name] = decoded[d_name]
                    out[i_name] = decoded[i_name]
                    out[c_name] = given[c_name]
                return _with_passthrough(out, given, present)


def _plane_entry(frame_fn, device: torch.device, scales: Optional[Mapping[str, float]],
                 use_flags: bool):
    """frame_fn's padded-plane entry (tiled.make_tiled_apply's `on_plane`)
    where the joint encode kernel can write the plane: the passes on the
    card, no scales (the kernel encodes unscaled), no flag planes; None
    where any of these fails or frame_fn has no such entry."""
    if device.type != "cuda" or scales or use_flags:
        return None
    return getattr(frame_fn, "on_plane", None)


def make_joint_frame_denoiser(
    model_cfg: ModelConfig,
    infer_cfg: InferenceConfig,
    height: int,
    width: int,
    params: Mapping[str, Any],
    groups: Sequence[str] = passes.LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
    use_flags: bool = False,
    scales: Optional[Mapping[str, float]] = None,
):
    """Joint-group mode: all light groups denoised in one network pass.

    `params` is the Flax parameter tree as numpy (weights_io.
    load_release_params). Runs on "cuda" unless `device` says otherwise;
    raises when there is no card. Returns (denoiser, grid).

    With infer_cfg.spatial_shard and a `mesh` (parallel/mesh.py) carrying a
    'spatial' axis, the network runs band-parallel over the mesh's devices
    (parallel/halo.py); the frame is encoded and decoded on its first one.

    use_flags: for flag-conditioned models (config.DataConfig.use_flags),
    see JointFrameDenoiser.
    """
    model, grid, dev = _load_model(model_cfg, infer_cfg, height, width, params, device, mesh)
    frame_fn = _frame_fn(model, grid, infer_cfg, transforms.joint_output_channels(tuple(groups)),
                         mesh=mesh, multiple=factory.spatial_multiple(model_cfg))
    return JointFrameDenoiser(model, grid, groups, aux, dev, scales, frame_fn, use_flags), grid


class GroupFrameDenoiser:
    """{pass_name: (H, W, C)} -> the joint denoiser's output dict, with each
    light group denoised by the same per-group network: the G encoded
    groups run as one (G, H, W, C) batch.

    `fused`: encode with ops/fused_ingest.encode_groups_fused (on the card
    one launch of its CUDA kernel writes every group's pixels straight into
    the batch) instead of transforms.encode_group_inputs. The kernels bake
    the unscaled transforms, so with `scales` the plain encoder runs either
    way, as in the JAX pipeline."""

    def __init__(self, model: factory.DenoiserModel, grid: tiled.TileGrid,
                 groups: Sequence[str], aux: Sequence[str], device: torch.device,
                 scales: Optional[Mapping[str, float]], fused: bool, frame_fn):
        self.model, self.grid, self.device = model, grid, device
        self.groups, self.aux, self.scales = tuple(groups), tuple(aux), scales
        self.fused = fused and not scales
        self.frame_fn = frame_fn

    def encode(self, pd: Mapping[str, Tensor]) -> Tensor:
        """(G, H, W, 9 + aux channels): every group's network input."""
        if not self.fused:
            return torch.stack([
                transforms.encode_group_inputs(pd, g, self.aux, scales=self.scales)
                for g in self.groups
            ], 0)
        return fused_ingest.encode_groups_fused(pd, self.groups, self.aux)

    @torch.inference_mode()
    def __call__(self, pass_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
        with tracing.span("frame"):
            pd = _to_device(pass_dict, self.device)
            with tracing.span("encode"):
                enc = self.encode(pd)
            with tracing.span("net"):
                dec = self.frame_fn(enc)  # (G, H, W, 6) log-demod direct+indirect
            with tracing.span("decode"):
                out: Dict[str, Tensor] = {}
                for i, g in enumerate(self.groups):
                    d_name, i_name, c_name = passes.group_passes(g)
                    decoded = transforms.decode_group_outputs(dec[i], pd[c_name], scales=self.scales)
                    out[d_name] = decoded["direct"]
                    out[i_name] = decoded["indirect"]
                    out[c_name] = pd[c_name]
                return _with_passthrough(out, pd, self.groups)


def make_group_frame_denoiser(
    model_cfg: ModelConfig,
    infer_cfg: InferenceConfig,
    height: int,
    width: int,
    params: Mapping[str, Any],
    groups: Sequence[str] = passes.LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
    scales: Optional[Mapping[str, float]] = None,
):
    """Group mode: one per-group network applied to every light group, the
    groups batched into one pass. Same output dict as the joint denoiser.

    infer_cfg.use_pallas_ingest keeps the JAX package's meaning: true →
    the fused ingest kernel (ops/fused_ingest.encode_groups_fused),
    false → transforms.encode_group_inputs. With stats-driven `scales` the
    plain encoder runs even if the flag is set, because the kernels bake
    the unscaled transforms. Runs on "cuda" unless `device` says otherwise;
    raises when there is no card. Returns (denoiser, grid).

    With infer_cfg.spatial_shard and a `mesh` carrying a 'spatial' axis,
    every group's rows run band-parallel over the mesh's devices, the
    groups batched in each band; the encode runs once, before the bands,
    on the mesh's first device.
    """
    model, grid, dev = _load_model(model_cfg, infer_cfg, height, width, params, device, mesh)
    frame_fn = _frame_fn(model, grid, infer_cfg, transforms.GROUP_OUTPUT_CHANNELS, batch_dims=1,
                         mesh=mesh, multiple=factory.spatial_multiple(model_cfg))
    return GroupFrameDenoiser(model, grid, groups, aux, dev, scales,
                              fused=infer_cfg.use_pallas_ingest, frame_fn=frame_fn), grid


class RgbFrameDenoiser:
    """{'combined', albedo, aux passes: (H, W, C)} -> {'combined': denoised}."""

    def __init__(self, model: factory.DenoiserModel, grid: tiled.TileGrid,
                 aux: Sequence[str], albedo_key: str, device: torch.device,
                 scales: Optional[Mapping[str, float]], frame_fn):
        self.model, self.grid, self.device = model, grid, device
        self.aux, self.albedo_key, self.scales = tuple(aux), albedo_key, scales
        self.frame_fn = frame_fn

    @torch.inference_mode()
    def __call__(self, pass_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
        with tracing.span("frame"):
            pd = _to_device(pass_dict, self.device)
            with tracing.span("encode"):
                enc = transforms.encode_rgb_inputs(pd, self.aux, self.albedo_key, scales=self.scales)
            with tracing.span("net"):
                dec = self.frame_fn(enc)
            with tracing.span("decode"):
                return {"combined": transforms.decode_rgb_outputs(dec, self.scales)}


def make_rgb_frame_denoiser(
    model_cfg: ModelConfig,
    infer_cfg: InferenceConfig,
    height: int,
    width: int,
    params: Mapping[str, Any],
    aux: Sequence[str] = ("normal", "depth"),
    albedo_key: str = "diffuse_color",
    device: Optional[Union[str, torch.device]] = None,
    scales: Optional[Mapping[str, float]] = None,
):
    """Combined-RGB mode at frame scale: noisy combined + albedo + aux ->
    denoised combined. Runs on "cuda" unless `device` says otherwise;
    raises when there is no card. Returns (denoiser, grid). As in the JAX
    package there is no mesh: infer_cfg.spatial_shard only keeps the
    certified halo of a whole frame."""
    model, grid, dev = _load_model(model_cfg, infer_cfg, height, width, params, device)
    return RgbFrameDenoiser(model, grid, aux, albedo_key, dev, scales,
                            _frame_fn(model, grid, infer_cfg, 3)), grid


@torch.inference_mode()
def denoise_crop(
    model_cfg: ModelConfig,
    params: Mapping[str, Any],
    pass_dict: Mapping[str, Any],
    aux: Sequence[str] = ("normal", "depth"),
    albedo_key: str = "diffuse_color",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Single-crop RGB denoise, no padding (the crop must be divisible by
    the model's spatial multiple), in the model's own compute dtype. Runs
    on "cuda" unless `device` says otherwise."""
    dev = device_lib.resolve(device)
    model = factory.build_model(model_cfg)
    weights_io.load_into(model, params)
    model.to(dev).eval()
    pd = _to_device(pass_dict, dev)
    enc = transforms.encode_rgb_inputs(pd, tuple(aux), albedo_key)[None]
    return transforms.decode_rgb_outputs(model(enc)[0])
