"""TF-checkpoint compatibility: TF1 name-based checkpoints to and from the
JAX-named parameter tree.

The port of deepdenoiser_tpu/compat/tf_checkpoint.py. The checkpoint
format is read and written by compat/tensor_bundle.py (numpy only; no
TensorFlow), and the name maps are the JAX package's, copied. Imports
return the {'params': {'UNet_0': ...}} tree of fp32 numpy arrays that
`weights_io.load_into` carries into a module, so that function stays the
one bridge to the port's `nn.Module`s.

Naming contract (the canonical TF scoping for a depth-D U-Net):

    unet/stem/conv<k>/{kernel,bias}        k = 0..convs_per_level-1
    unet/enc<l>/down/{kernel,bias}         l = 1..D
    unet/enc<l>/conv<k>/{kernel,bias}
    unet/dec<l>/up/{kernel,bias}           l = D-1..0 (decoder level)
    unet/dec<l>/conv<k>/{kernel,bias}
    unet/head/{kernel,bias}

and for the FC-DenseNet and the KPN head as the tiramisu map and
`kpn/kernel_temp` below say. Layout: TF conv kernels are HWIO, as the JAX
tree keeps them; `load_into` transposes to PyTorch's OIHW. A source in
another layout goes through the `kernel_transform(tf_name, array)` hook.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from deepdenoiser_tpu_torch.compat import tensor_bundle
from deepdenoiser_tpu_torch.weights_io import flatten

_OPTIMIZER_SUFFIXES = ("/Adam", "/Adam_1", "global_step", "beta1_power", "beta2_power")


class UnmappedVariableError(KeyError):
    """A TF variable (or Flax path) with no mapping for the given model
    family; the message names the family and the offending variable."""


def load_tf_checkpoint_arrays(path: str | Path) -> Dict[str, np.ndarray]:
    """Read every variable of a TF checkpoint into numpy."""
    return tensor_bundle.read_bundle(path)


def tf_name_to_flax_path(name: str, depth: int) -> Optional[str]:
    """One canonical TF variable name -> '/'-joined Flax path (or None for
    optimizer slots). The U-Net's Flax auto-indexing:
      ConvStack_0 = stem; ConvStack_l = encoder level l (1..D);
      DownSample_{l-1} = encoder level l's downsample;
      UpSample_u / ConvStack_{D+1+u} = u-th decoder step (level D-1-u);
      Conv_0 = linear head.
    """
    if name.endswith(_OPTIMIZER_SUFFIXES):
        return None
    m = re.fullmatch(r"unet/stem/conv(\d+)/(kernel|bias)", name)
    if m:
        return f"ConvStack_0/ConvBlock_{m.group(1)}/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"unet/enc(\d+)/down/(kernel|bias)", name)
    if m:
        return f"DownSample_{int(m.group(1)) - 1}/ConvBlock_0/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"unet/enc(\d+)/conv(\d+)/(kernel|bias)", name)
    if m:
        return f"ConvStack_{int(m.group(1))}/ConvBlock_{m.group(2)}/Conv_0/{m.group(3)}"
    m = re.fullmatch(r"unet/dec(\d+)/up/(kernel|bias)", name)
    if m:
        u = depth - 1 - int(m.group(1))
        return f"UpSample_{u}/ConvBlock_0/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"unet/dec(\d+)/conv(\d+)/(kernel|bias)", name)
    if m:
        u = depth - 1 - int(m.group(1))
        return f"ConvStack_{depth + 1 + u}/ConvBlock_{m.group(2)}/Conv_0/{m.group(3)}"
    m = re.fullmatch(r"unet/head/(kernel|bias)", name)
    if m:
        return f"Conv_0/{m.group(1)}"
    raise UnmappedVariableError(f"unet: unmapped TF variable {name!r}")


def flax_path_to_tf_name(path: str, depth: int) -> str:
    """Inverse mapping (used by the exporter)."""
    m = re.fullmatch(r"ConvStack_(\d+)/ConvBlock_(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        s, k, leaf = int(m.group(1)), m.group(2), m.group(3)
        if s == 0:
            return f"unet/stem/conv{k}/{leaf}"
        if s <= depth:
            return f"unet/enc{s}/conv{k}/{leaf}"
        level = depth - 1 - (s - depth - 1)
        return f"unet/dec{level}/conv{k}/{leaf}"
    m = re.fullmatch(r"DownSample_(\d+)/ConvBlock_0/Conv_0/(kernel|bias)", path)
    if m:
        return f"unet/enc{int(m.group(1)) + 1}/down/{m.group(2)}"
    m = re.fullmatch(r"UpSample_(\d+)/ConvBlock_0/Conv_0/(kernel|bias)", path)
    if m:
        return f"unet/dec{depth - 1 - int(m.group(1))}/up/{m.group(2)}"
    m = re.fullmatch(r"Conv_0/(kernel|bias)", path)
    if m:
        return f"unet/head/{m.group(1)}"
    raise UnmappedVariableError(f"unet: unmapped Flax path {path!r}")


def tiramisu_tf_name_to_flax_path(name: str, depth: int) -> Optional[str]:
    """Canonical TF scoping for a depth-D FC-DenseNet:

        tiramisu/stem/{kernel,bias}                 3x3 entry conv
        tiramisu/down<l>/dense/layer<j>/...         l = 0..D-1
        tiramisu/down<l>/transition/...             1x1 transition-down
        tiramisu/bottleneck/layer<j>/...
        tiramisu/up<u>/upsample/...                 u = 0..D-1
        tiramisu/up<u>/compress/...                 1x1 (up_compress > 0)
        tiramisu/up<u>/dense/layer<j>/...
        tiramisu/head/{kernel,bias}

    Flax auto-indexing: ConvBlock_0 = stem; DenseBlock_l (l<D) = down
    dense; ConvBlock_{l+1} (1<=l+1<=D) = transition; DenseBlock_D =
    bottleneck; UpSample_u + ConvBlock_{D+1+u} (compress) +
    DenseBlock_{D+1+u} = up step u; Conv_0 = head.
    """
    if name.endswith(_OPTIMIZER_SUFFIXES):
        return None
    m = re.fullmatch(r"tiramisu/stem/(kernel|bias)", name)
    if m:
        return f"ConvBlock_0/Conv_0/{m.group(1)}"
    m = re.fullmatch(r"tiramisu/down(\d+)/dense/layer(\d+)/(kernel|bias)", name)
    if m:
        return f"DenseBlock_{m.group(1)}/ConvBlock_{m.group(2)}/Conv_0/{m.group(3)}"
    m = re.fullmatch(r"tiramisu/down(\d+)/transition/(kernel|bias)", name)
    if m:
        return f"ConvBlock_{int(m.group(1)) + 1}/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"tiramisu/bottleneck/layer(\d+)/(kernel|bias)", name)
    if m:
        return f"DenseBlock_{depth}/ConvBlock_{m.group(1)}/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"tiramisu/up(\d+)/upsample/(kernel|bias)", name)
    if m:
        return f"UpSample_{m.group(1)}/ConvBlock_0/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"tiramisu/up(\d+)/compress/(kernel|bias)", name)
    if m:
        return f"ConvBlock_{depth + 1 + int(m.group(1))}/Conv_0/{m.group(2)}"
    m = re.fullmatch(r"tiramisu/up(\d+)/dense/layer(\d+)/(kernel|bias)", name)
    if m:
        return (
            f"DenseBlock_{depth + 1 + int(m.group(1))}/"
            f"ConvBlock_{m.group(2)}/Conv_0/{m.group(3)}"
        )
    m = re.fullmatch(r"tiramisu/head/(kernel|bias)", name)
    if m:
        return f"Conv_0/{m.group(1)}"
    raise UnmappedVariableError(f"tiramisu: unmapped TF variable {name!r}")


def tiramisu_flax_path_to_tf_name(path: str, depth: int) -> str:
    """Inverse of tiramisu_tf_name_to_flax_path."""
    m = re.fullmatch(r"ConvBlock_(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        b, leaf = int(m.group(1)), m.group(2)
        if b == 0:
            return f"tiramisu/stem/{leaf}"
        if b <= depth:
            return f"tiramisu/down{b - 1}/transition/{leaf}"
        return f"tiramisu/up{b - depth - 1}/compress/{leaf}"
    m = re.fullmatch(r"DenseBlock_(\d+)/ConvBlock_(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        d, j, leaf = int(m.group(1)), m.group(2), m.group(3)
        if d < depth:
            return f"tiramisu/down{d}/dense/layer{j}/{leaf}"
        if d == depth:
            return f"tiramisu/bottleneck/layer{j}/{leaf}"
        return f"tiramisu/up{d - depth - 1}/dense/layer{j}/{leaf}"
    m = re.fullmatch(r"UpSample_(\d+)/ConvBlock_0/Conv_0/(kernel|bias)", path)
    if m:
        return f"tiramisu/up{m.group(1)}/upsample/{m.group(2)}"
    m = re.fullmatch(r"Conv_0/(kernel|bias)", path)
    if m:
        return f"tiramisu/head/{m.group(1)}"
    raise UnmappedVariableError(f"tiramisu: unmapped Flax path {path!r}")


# ---------------------------------------------------------------------------
# Whole-zoo dispatch. The top-level tree is keyed by the backbone module
# name; multiscale shares the plain UNet tree verbatim (the wrapper owns no
# parameters), and KPN adds one variable (the bounded softmax temperature)
# next to its backbone.
# ---------------------------------------------------------------------------

_KPN_TEMP_TF = "kpn/kernel_temp"
_KPN_TEMP_FLAX = "KernelPredictionHead_0/kernel_temp"


def full_flax_path_to_tf_name(path: str, mcfg) -> str:
    """Top-level Flax path ('UNet_0/...', 'Tiramisu_0/...',
    'KernelPredictionHead_0/kernel_temp') -> canonical TF name."""
    if path == _KPN_TEMP_FLAX:
        return _KPN_TEMP_TF
    top, _, rest = path.partition("/")
    if top == "UNet_0":
        return flax_path_to_tf_name(rest, mcfg.depth)
    if top == "Tiramisu_0":
        return tiramisu_flax_path_to_tf_name(rest, mcfg.depth)
    raise UnmappedVariableError(
        f"{mcfg.backbone}: unmapped top-level Flax module in {path!r} "
        "(expected UNet_0 / Tiramisu_0 / KernelPredictionHead_0)"
    )


def full_tf_name_to_flax_path(name: str, mcfg) -> Optional[str]:
    """Canonical TF name -> top-level Flax path (None = optimizer slot)."""
    if name.endswith(_OPTIMIZER_SUFFIXES):
        return None
    if name == _KPN_TEMP_TF:
        if not mcfg.kernel_prediction:
            raise UnmappedVariableError(
                f"{_KPN_TEMP_TF} in checkpoint but model is not a KPN"
            )
        return _KPN_TEMP_FLAX
    if name.startswith("unet/"):
        if mcfg.backbone != "unet":
            raise UnmappedVariableError(
                f"unet-scoped variable {name!r} but backbone is {mcfg.backbone!r}"
            )
        return f"UNet_0/{tf_name_to_flax_path(name, mcfg.depth)}"
    if name.startswith("tiramisu/"):
        if mcfg.backbone != "tiramisu":
            raise UnmappedVariableError(
                f"tiramisu-scoped variable {name!r} but backbone is {mcfg.backbone!r}"
            )
        return f"Tiramisu_0/{tiramisu_tf_name_to_flax_path(name, mcfg.depth)}"
    raise UnmappedVariableError(
        f"unknown scope for TF variable {name!r} (expected unet/, tiramisu/, or kpn/)"
    )


def _import(ckpt_path, to_path: Callable[[str], Optional[str]],
            kernel_transform: Optional[Callable[[str, np.ndarray], np.ndarray]]
            ) -> Dict[str, Any]:
    flat: Dict[str, np.ndarray] = {}
    for name, arr in load_tf_checkpoint_arrays(ckpt_path).items():
        path = to_path(name)
        if path is None:
            continue
        if kernel_transform is not None:
            arr = kernel_transform(name, arr)
        flat[path] = arr
    return _unflatten(flat)


def import_checkpoint(
    ckpt_path: str | Path,
    mcfg,
    kernel_transform: Optional[Callable[[str, np.ndarray], np.ndarray]] = None,
) -> Dict[str, Any]:
    """TF checkpoint -> {'params': ...} tree for factory.build_model(mcfg)
    (through weights_io.load_into). Covers every zoo family (unet /
    tiramisu / multiscale / KPN)."""
    return {"params": _import(ckpt_path, lambda n: full_tf_name_to_flax_path(n, mcfg),
                              kernel_transform)}


def export_checkpoint(
    params: Mapping[str, Any], mcfg, ckpt_path: str | Path
) -> List[str]:
    """Flax params (any zoo family) -> TF1 name-based checkpoint (fp32).
    Returns the TF variable names written."""
    named = {
        full_flax_path_to_tf_name(path, mcfg): np.asarray(arr, np.float32)
        for path, arr in flatten(dict(params["params"])).items()
    }
    tensor_bundle.write_bundle(ckpt_path, named)
    return sorted(named)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr, dtype=np.float32)
    return root


def import_unet_checkpoint(
    ckpt_path: str | Path,
    depth: int,
    kernel_transform: Optional[Callable[[str, np.ndarray], np.ndarray]] = None,
) -> Dict[str, Any]:
    """TF checkpoint -> {'params': {'UNet_0': ...}} tree for a U-Net of
    `depth`. `kernel_transform(tf_name, arr)` hooks layout fixes for
    non-HWIO sources."""
    return {"params": {"UNet_0": _import(ckpt_path, lambda n: tf_name_to_flax_path(n, depth),
                                         kernel_transform)}}


def export_unet_checkpoint(
    params: Mapping[str, Any], depth: int, ckpt_path: str | Path
) -> List[str]:
    """Write U-Net params as a TF name-based checkpoint (the format
    upstream's estimator emitted). Returns the TF variable names written."""
    inner = params["params"]
    if "UNet_0" in inner:
        inner = inner["UNet_0"]
    named = {
        flax_path_to_tf_name(path, depth): np.asarray(arr, np.float32)
        for path, arr in flatten(inner).items()
    }
    tensor_bundle.write_bundle(ckpt_path, named)
    return sorted(named)


def structural_diff(
    params: Mapping[str, Any], template: Mapping[str, Any]
) -> List[str]:
    """Same tree paths + shapes? Returns human-readable mismatches."""
    a = {k: v.shape for k, v in flatten(dict(params)).items()}
    b = {k: v.shape for k, v in flatten(dict(template)).items()}
    problems = []
    for k in sorted(set(a) | set(b)):
        if k not in a:
            problems.append(f"missing in import: {k} {b[k]}")
        elif k not in b:
            problems.append(f"unexpected in import: {k} {a[k]}")
        elif tuple(a[k]) != tuple(b[k]):
            problems.append(f"shape mismatch {k}: got {a[k]}, want {b[k]}")
    return problems
