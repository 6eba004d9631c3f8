"""Release-weight IO and the carry-over of JAX parameter trees.

The release format (weights/*.npz) is a flat npz of '/'-joined Flax param
paths in float16; `load_release_params` reads it as the JAX package's
weights_io does (fp16 on disk, fp32 in memory) and returns the same
nested {'params': ...} tree of numpy arrays.

`state_dict_from_params` turns such a tree — from a release file or from
the JAX package's own `init_params`, as numpy — into the port's
state_dict. The port's modules carry the Flax scope names (UNet_0,
ConvStack_3, ConvBlock_1, Conv_0, ...), so a Flax path maps to a torch key
by joining with '.': a conv `kernel` (HWIO) becomes `weight` (OIHW), a
`bias` stays `bias`, and KernelPredictionHead_0/kernel_temp goes across as
it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def load_release_params(path) -> Dict[str, Any]:
    """npz -> {'params': ...} tree of float32 numpy arrays."""
    with np.load(path) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    return unflatten(flat)


def state_dict_from_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves, with or without the top-level
    'params' key) -> torch state_dict with OIHW conv weights."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flatten(params).items():
        *scope, leaf = path.split("/")
        arr = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{path}: conv kernel must be 4-D HWIO, got {arr.shape}")
            key, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf in ("bias", "kernel_temp"):
            key = leaf
        else:
            raise ValueError(f"{path}: unknown parameter kind {leaf!r}")
        out[".".join(scope + [key])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_into(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Carry a Flax param tree into `module`; a leftover or missing key,
    or a shape that disagrees, is an error."""
    sd = state_dict_from_params(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    leftover = sorted(set(sd) - set(own))
    if missing or leftover:
        raise KeyError(
            f"parameter tree does not fit {type(module).__name__}: "
            f"missing {missing}, leftover {leftover}"
        )
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != model's {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
