"""Full-frame multi-pass denoising pipeline on the card.

The port of deepdenoiser_tpu/inference/pipeline.py:

  joint  encode all light groups into one 41-channel NHWC stack (+ one
         presence plane per group with use_flags) → reflect-pad to the
         padded plane → DenoiserModel over the plane or its tiles → crop or
         stitch → expm1 / remodulate
  group  encode each light group into its own 14-channel stack, all groups
         as one (G, H, W, 14) batch → pad → DenoiserModel over the batch of
         planes or tiles → crop or stitch → decode per group
  rgb    noisy combined + albedo + aux → pad → DenoiserModel → crop or
         stitch → expm1

and, for joint and group, recompose Σ color⊙(direct+indirect) + emission +
environment on the device. InferenceConfig chooses whole-frame (tile=0) or
tiled execution (tile, tile_batch, stitch): inference/tiled.py.

PyTorch runs eagerly, so each factory builds the model once, loads the
weights onto the device and returns a callable on a pass dict. The kernels
follow the tensors: on the card the KPN filter apply (ops/kpn_apply.py)
and, with InferenceConfig.use_pallas_ingest, the group encode
(ops/fused_ingest.py) are CUDA kernels; on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import passes, transforms, weights_io
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.ops import fused_ingest

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
    """What every frame factory shares: refuse the multi-device modes,
    resolve the device (the card, or raise), plan the plane, build the model
    in the inference dtype and load `params` onto the device."""
    if infer_cfg.spatial_shard or mesh is not None:
        raise NotImplementedError(
            "spatial sharding (band-parallel frames over a mesh) comes with the "
            "multi-device slice of the port")
    if infer_cfg.stitch not in ("exact", "feather"):
        raise ValueError(f"stitch must be 'exact' or 'feather', got {infer_cfg.stitch!r}")
    dev = device_lib.resolve(device)
    grid = plan_for(model_cfg, infer_cfg, height, width)
    model = factory.build_model(
        dataclasses.replace(model_cfg, compute_dtype=infer_cfg.compute_dtype)
    )
    weights_io.load_into(model, params)
    model.to(dev).eval()
    return model, grid, dev


def _frame_fn(model, grid: tiled.TileGrid, infer_cfg: InferenceConfig, out_channels: int,
              batch_dims: int = 0):
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
    left out of the outputs and of the recomposition."""

    def __init__(self, model: factory.DenoiserModel, grid: tiled.TileGrid,
                 groups: Sequence[str], aux: Sequence[str], device: torch.device,
                 scales: Optional[Mapping[str, float]], frame_fn, use_flags: bool = False):
        self.model, self.grid, self.device = model, grid, device
        self.groups, self.aux, self.scales = tuple(groups), tuple(aux), scales
        self.frame_fn, self.use_flags = frame_fn, use_flags

    @torch.inference_mode()
    def __call__(self, pass_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
        given = _to_device(pass_dict, self.device)
        pd = dict(given)
        present = self.groups
        h, w = self.grid.height, self.grid.width
        if self.use_flags:
            present = tuple(g for g in self.groups
                            if all(nm in given for nm in passes.group_passes(g)))
            for g in self.groups:
                if g not in present:
                    for nm in passes.group_passes(g):
                        pd[nm] = torch.zeros((h, w, 3), dtype=torch.float32, device=self.device)
        enc = transforms.encode_joint_inputs(pd, self.groups, self.aux, scales=self.scales)
        if self.use_flags:
            bits = torch.tensor([1.0 if g in present else 0.0 for g in self.groups],
                                dtype=torch.float32, device=self.device)
            enc = torch.cat((enc, bits.expand(h, w, len(self.groups))), dim=-1)
        dec = self.frame_fn(enc)
        decoded = transforms.decode_joint_outputs(dec, pd, self.groups, scales=self.scales)
        out: Dict[str, Tensor] = {}
        for g in present:
            d_name, i_name, c_name = passes.group_passes(g)
            out[d_name] = decoded[d_name]
            out[i_name] = decoded[i_name]
            out[c_name] = given[c_name]
        return _with_passthrough(out, given, present)


def make_joint_frame_denoiser(
    model_cfg: ModelConfig,
    infer_cfg: InferenceConfig,
    height: int,
    width: int,
    params: Mapping[str, Any],
    groups: Sequence[str] = passes.LIGHT_GROUPS,
    aux: Sequence[str] = passes.AUX_PASSES,
    device: Optional[Union[str, torch.device]] = None,
    use_flags: bool = False,
    scales: Optional[Mapping[str, float]] = None,
):
    """Joint-group mode: all light groups denoised in one network pass.

    `params` is the Flax parameter tree as numpy (weights_io.
    load_release_params). Runs on "cuda" unless `device` says otherwise;
    raises when there is no card. Returns (denoiser, grid).

    use_flags: for flag-conditioned models (config.DataConfig.use_flags),
    see JointFrameDenoiser.
    """
    model, grid, dev = _load_model(model_cfg, infer_cfg, height, width, params, device)
    frame_fn = _frame_fn(model, grid, infer_cfg, transforms.joint_output_channels(tuple(groups)))
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
        pd = _to_device(pass_dict, self.device)
        dec = self.frame_fn(self.encode(pd))  # (G, H, W, 6) log-demod direct+indirect
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
    """
    model, grid, dev = _load_model(model_cfg, infer_cfg, height, width, params, device, mesh)
    frame_fn = _frame_fn(model, grid, infer_cfg, transforms.GROUP_OUTPUT_CHANNELS, batch_dims=1)
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
        pd = _to_device(pass_dict, self.device)
        enc = transforms.encode_rgb_inputs(pd, self.aux, self.albedo_key, scales=self.scales)
        return {"combined": transforms.decode_rgb_outputs(self.frame_fn(enc), self.scales)}


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
    raises when there is no card. Returns (denoiser, grid)."""
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
