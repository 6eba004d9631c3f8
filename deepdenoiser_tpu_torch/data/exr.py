"""EXR frame-directory ingest and export (upstream: TensorFlow/OpenEXRDirectory.py — SURVEY.md C5).

A copy of deepdenoiser_tpu/data/exr.py for the PyTorch package.

Disk contract (what the Blender-side generator writes, and what
prepare-data consumes): one directory per rendered frame containing one
EXR file per render pass, named `<pass_name>.exr` with the canonical pass
names from passes.REGISTRY; Cycles' own pass naming ("DiffDir",
"GlossCol", ...) is accepted via CYCLES_NAME_MAP. Multilayer EXRs (one
file, channels "DiffDir.R" etc., as Blender's File Output node emits) are
also ingested via load_multilayer_exr.

Backed by the framework's own pure-numpy EXR codec (exr_codec.py) since
the environment ships no EXR library.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.data import exr_codec

# Blender/Cycles render-layer pass names -> canonical registry names.
CYCLES_NAME_MAP: Dict[str, str] = {
    "Combined": "combined",
    "Image": "combined",
    "DiffDir": "diffuse_direct",
    "DiffInd": "diffuse_indirect",
    "DiffCol": "diffuse_color",
    "GlossDir": "glossy_direct",
    "GlossInd": "glossy_indirect",
    "GlossCol": "glossy_color",
    "SubsurfaceDir": "subsurface_direct",
    "SubsurfaceInd": "subsurface_indirect",
    "SubsurfaceCol": "subsurface_color",
    "TransDir": "transmission_direct",
    "TransInd": "transmission_indirect",
    "TransCol": "transmission_color",
    "Emit": "emission",
    "Env": "environment",
    "Normal": "normal",
    "Depth": "depth",
    "Z": "depth",
    "Alpha": "alpha",
}
_CANONICAL_TO_CYCLES = {
    v: k for k, v in CYCLES_NAME_MAP.items() if k not in ("Image", "Z")
}

# Channel-name conventions for single-pass EXR files, by channel count.
_RGB = ("R", "G", "B")
_MONO_ALIASES = ("Y", "Z", "A", "V", "G")


def _canonical_pass_name(stem: str) -> Optional[str]:
    if stem in passes.REGISTRY:
        return stem
    return CYCLES_NAME_MAP.get(stem)


def _image_to_hwc(img: exr_codec.ExrImage) -> np.ndarray:
    """Collapse a single-pass EXR's channels into HWC float32 (RGB order)."""
    chans = img.channels
    if all(c in chans for c in _RGB):
        stack = [chans["R"], chans["G"], chans["B"]]
        if "A" in chans and len(chans) == 4:
            stack.append(chans["A"])
        return np.stack(stack, axis=-1).astype(np.float32)
    if len(chans) == 1:
        return next(iter(chans.values())).astype(np.float32)[..., None]
    names = sorted(chans)
    if all(len(n) == 3 and n[0] == "C" and n[1:].isdigit() for n in names):
        # this module's own write_exr convention for >4-channel data: C00..Cnn
        return np.stack([chans[n] for n in names], axis=-1).astype(np.float32)
    if set(names) in ({"X", "Y", "Z"}, {"X", "Y"}):
        # vector/normal passes from external tools (X/Y/Z convention) —
        # same component order as load_multilayer_exr (ADVICE r2 #3)
        return np.stack(
            [chans[n] for n in ("X", "Y", "Z") if n in chans], axis=-1
        ).astype(np.float32)
    # Refuse to guess: alphabetical stacking would silently scramble channel
    # order for other layouts (VERDICT r1 weak #9).
    raise ValueError(
        f"unrecognized EXR channel layout {names}; expected R/G/B[/A], a "
        "single channel, X/Y[/Z], or the C## convention"
    )


def read_exr(path: str | Path) -> np.ndarray:
    """Read one single-pass EXR as float32 HWC."""
    return _image_to_hwc(exr_codec.read(path))


def write_exr(
    path: str | Path,
    arr: np.ndarray,
    pixel_type: str = "float",
    compression: str = "zip",
) -> None:
    """Write float32 HWC (1/3/4 channels) as an EXR with standard channel names."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    c = arr.shape[-1]
    if c == 1:
        chans = {"Y": arr[..., 0]}
    elif c == 3:
        chans = {"R": arr[..., 0], "G": arr[..., 1], "B": arr[..., 2]}
    elif c == 4:
        chans = {
            "R": arr[..., 0], "G": arr[..., 1], "B": arr[..., 2], "A": arr[..., 3]
        }
    else:
        chans = {f"C{i:02d}": arr[..., i] for i in range(c)}
    exr_codec.write(path, chans, pixel_type=pixel_type, compression=compression)


def _validate_channels(name: str, arr: np.ndarray, path: object) -> np.ndarray:
    want_c = passes.channels(name)
    if arr.shape[-1] == 4 and want_c == 3:
        arr = arr[..., :3]  # drop alpha embedded in RGBA files
    if arr.shape[-1] != want_c:
        if arr.shape[-1] > want_c:
            arr = arr[..., :want_c]
        else:
            raise ValueError(
                f"{path}: pass {name} has {arr.shape[-1]} channels, want {want_c}"
            )
    return arr


def load_frame_dir(
    frame_dir: str | Path,
    wanted: Optional[Iterable[str]] = None,
    strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Load a frame directory of per-pass EXRs into {canonical_name: HWC f32}."""
    frame_dir = Path(frame_dir)
    found: Dict[str, Path] = {}
    all_exrs = sorted(frame_dir.glob("*.exr"))
    for p in all_exrs:
        name = _canonical_pass_name(p.stem)
        if name is not None:
            found[name] = p
    if not found and all_exrs:
        # Blender's multilayer output: one EXR carrying every pass
        # (blender/render_passes.py writes this shape).
        return load_multilayer_exr(all_exrs[0], wanted=wanted, strict=strict)
    wanted_set = set(wanted) if wanted is not None else set(found)
    missing = wanted_set - set(found)
    if missing and strict:
        raise FileNotFoundError(f"{frame_dir}: missing passes {sorted(missing)}")

    out: Dict[str, np.ndarray] = {}
    shape_hw: Optional[Tuple[int, int]] = None
    for name in sorted(wanted_set & set(found)):
        arr = _validate_channels(name, read_exr(found[name]), found[name])
        if shape_hw is None:
            shape_hw = arr.shape[:2]
        elif arr.shape[:2] != shape_hw:
            raise ValueError(f"{frame_dir}: inconsistent pass resolutions")
        out[name] = arr
    return out


def load_multilayer_exr(
    path: str | Path,
    wanted: Optional[Iterable[str]] = None,
    strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Load a Blender multilayer EXR: channels named '<Layer.>Pass.R' etc.

    The render-layer prefix (if any) is stripped; the pass component is
    mapped through CYCLES_NAME_MAP / the registry.
    """
    img = exr_codec.read(path)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for cname, arr in img.channels.items():
        parts = cname.split(".")
        comp = parts[-1] if len(parts) > 1 else "Y"
        stem = parts[-2] if len(parts) >= 2 else parts[0]
        name = _canonical_pass_name(stem)
        if name is None and len(parts) == 1:
            # bare R/G/B/A/Z channels -> combined / depth / alpha
            if parts[0] in ("R", "G", "B"):
                name, comp = "combined", parts[0]
            elif parts[0] == "A":
                name, comp = "alpha", "Y"
            elif parts[0] == "Z":
                name, comp = "depth", "Y"
        if name is None:
            continue
        groups.setdefault(name, {})[comp] = arr

    out: Dict[str, np.ndarray] = {}
    for name, comps in groups.items():
        want_c = passes.channels(name)
        if want_c == 1:
            arr = next(iter(comps.values()))[..., None]
        else:
            order = [c for c in ("R", "G", "B", "A", "X", "Y", "Z") if c in comps]
            if len(order) < want_c:
                order = sorted(comps)
            arr = np.stack([comps[c] for c in order[:want_c]], axis=-1)
        out[name] = _validate_channels(name, arr.astype(np.float32), path)

    if wanted is not None:
        missing = set(wanted) - set(out)
        if missing and strict:
            raise FileNotFoundError(f"{path}: missing passes {sorted(missing)}")
        out = {k: v for k, v in out.items() if k in set(wanted)}
    return out


def save_frame_dir(
    frame_dir: str | Path,
    pass_dict: Mapping[str, np.ndarray],
    cycles_names: bool = False,
    pixel_type: str = "float",
) -> None:
    """Write a pass dict as a frame directory of per-pass EXRs."""
    frame_dir = Path(frame_dir)
    frame_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in pass_dict.items():
        fname = _CANONICAL_TO_CYCLES.get(name, name) if cycles_names else name
        write_exr(frame_dir / f"{fname}.exr", arr, pixel_type=pixel_type)


def save_multilayer_exr(
    path: str | Path,
    pass_dict: Mapping[str, np.ndarray],
    pixel_type: str = "float",
) -> None:
    """Write a pass dict as one multilayer EXR (channels 'pass.R' etc.)."""
    chans: Dict[str, np.ndarray] = {}
    for name, arr in pass_dict.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] == 1:
            chans[f"{name}.Y"] = arr[..., 0]
        else:
            for i, comp in enumerate("RGBA"[: arr.shape[-1]]):
                chans[f"{name}.{comp}"] = arr[..., i]
    exr_codec.write(path, chans, pixel_type=pixel_type)
