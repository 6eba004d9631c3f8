"""Full-frame joint-group denoising pipeline on the card.

The port of deepdenoiser_tpu/inference/pipeline.py's joint mode
(make_joint_frame_denoiser), whole-frame:

  encode all light groups into one 41-channel NHWC stack
  → reflect-pad to the padded plane → DenoiserModel (UNet + KPN head or
  residual) → crop → expm1 / remodulate → recompose
  Σ color⊙(direct+indirect) + emission + environment.

PyTorch runs eagerly, so the factory builds the model once, loads the
weights onto the device and returns a callable on a pass dict. The KPN
filter apply follows the tensors: on the card it is the CUDA kernel
(ops/kpn_apply.py), on the CPU its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch

from deepdenoiser_tpu_torch import device as device_lib
from deepdenoiser_tpu_torch import passes, transforms, weights_io
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig

Tensor = torch.Tensor


def plan_for(
    model_cfg: ModelConfig, infer_cfg: InferenceConfig, height: int, width: int
) -> tiled.TileGrid:
    halo = infer_cfg.halo if infer_cfg.halo > 0 else factory.halo(model_cfg)
    if infer_cfg.tile == 0 and not infer_cfg.spatial_shard and infer_cfg.border >= 0:
        # Whole-frame mode: the pad is border context only, so the smaller
        # reflect border of InferenceConfig.border applies.
        halo = min(halo, infer_cfg.border)
    return tiled.plan_grid(
        height, width, infer_cfg.tile, halo, factory.spatial_multiple(model_cfg)
    )


class JointFrameDenoiser:
    """{pass_name: (H, W, C)} -> denoised '<g>_direct' / '<g>_indirect' per
    group, the color passes, emission / environment / alpha passed through,
    and 'combined' recomposed — the JAX pipeline's output dict."""

    def __init__(self, model: factory.DenoiserModel, grid: tiled.TileGrid,
                 groups: Sequence[str], aux: Sequence[str], device: torch.device,
                 scales: Optional[Mapping[str, float]]):
        self.model, self.grid, self.device = model, grid, device
        self.groups, self.aux, self.scales = tuple(groups), tuple(aux), scales

    @torch.inference_mode()
    def __call__(self, pass_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
        pd = {
            k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
            for k, v in pass_dict.items()
        }
        enc = transforms.encode_joint_inputs(pd, self.groups, self.aux, scales=self.scales)
        dec = tiled.whole_frame_reference(self.model, enc, self.grid)
        decoded = transforms.decode_joint_outputs(dec, pd, self.groups, scales=self.scales)
        out: Dict[str, Tensor] = {}
        for g in self.groups:
            d_name, i_name, c_name = passes.group_passes(g)
            out[d_name] = decoded[d_name]
            out[i_name] = decoded[i_name]
            out[c_name] = pd[c_name]
        for extra in passes.COMPOSITE_EXTRA + ("alpha",):
            if extra in pd:
                out[extra] = pd[extra]
        out["combined"] = transforms.recompose(out, self.groups)
        return out


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
    """
    if use_flags:
        raise NotImplementedError("use_flags (flag-conditioned models) is not ported yet")
    if infer_cfg.spatial_shard:
        raise NotImplementedError("spatial sharding is not ported yet")
    if infer_cfg.tile or infer_cfg.tile_batch or infer_cfg.stitch != "exact":
        raise NotImplementedError("tiled inference is not ported yet (tile=0 only)")
    dev = device_lib.resolve(device)
    grid = plan_for(model_cfg, infer_cfg, height, width)
    model = factory.build_model(
        dataclasses.replace(model_cfg, compute_dtype=infer_cfg.compute_dtype)
    )
    weights_io.load_into(model, params)
    model.to(dev).eval()
    return JointFrameDenoiser(model, grid, groups, aux, dev, scales), grid
