"""Plain reference of one multi-pass frame through a frame denoiser: encode,
the padded plane, the network in row bands, crop, decode, recompose.

Frozen from deepdenoiser_tpu_torch/transforms.py, inference/pipeline.py and
inference/tiled.py at commit 903e8b8 and written again in plain torch:
  * joint mode: one (H, W, 41) stack, [log1p(direct / (albedo + 0.01)),
    log1p(indirect / (albedo + 0.01)), albedo] per light group, then
    normal clamped to [-1, 1], log1p(depth), alpha clamped to [0, 1];
  * group mode: a (4, H, W, 14) batch, each group's 9 channels and the aux;
  * the plane: the frame reflect-padded by the halo on top and left, by
    the halo and the rounding to the model's multiple on bottom and right;
    whole-frame mode pads by min(certified halo, border), tiled mode by the
    certified halo, and a tiled frame then equals the whole plane's
    network output at every frame pixel (the tiles' exact stitch);
  * the network runs over row bands of the plane, each with the certified
    halo of context above and below (so a band equals the whole plane's
    rows; one band when the plane fits `band_rows`);
  * decode: expm1(max(y, 0)) * (albedo + 0.01) per group; recompose:
    sum color * (direct + indirect) + emission + environment.
It reads the pass dict and the parameters it is given, and nothing the
program made.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

LIGHT_GROUPS = ("diffuse", "glossy", "subsurface", "transmission")
EPS = 1e-2


def _groups(g: str):
    return f"{g}_direct", f"{g}_indirect", f"{g}_color"


def _log(x: Tensor) -> Tensor:
    return torch.log1p(torch.clamp_min(x, 0.0))


def _aux(pd: Mapping[str, Tensor]):
    return [torch.clamp(pd["normal"], -1.0, 1.0), _log(pd["depth"]),
            torch.clamp(pd["alpha"], 0.0, 1.0)]


def _group_feats(pd: Mapping[str, Tensor], g: str):
    d, i, c = _groups(g)
    albedo = pd[c]
    return [_log(pd[d] / (albedo + EPS)), _log(pd[i] / (albedo + EPS)), albedo]


def encode(pd: Mapping[str, Tensor], mode: str) -> Tensor:
    """(G, H, W, C) network input: G = 1 in joint mode, 4 in group mode."""
    if mode == "joint":
        feats = [f for g in LIGHT_GROUPS for f in _group_feats(pd, g)]
        return torch.cat(feats + _aux(pd), dim=-1)[None]
    if mode == "group":
        return torch.stack([torch.cat(_group_feats(pd, g) + _aux(pd), dim=-1)
                            for g in LIGHT_GROUPS])
    raise ValueError(f"unknown mode {mode!r}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plane_halo(infer: Mapping, certified: int, multiple: int) -> int:
    halo = infer["halo"] if infer["halo"] > 0 else certified
    if infer["tile"] == 0 and infer["border"] >= 0:
        halo = min(halo, infer["border"])
    return _round_up(halo, multiple)


def pad_plane(x: Tensor, halo: int, multiple: int) -> Tensor:
    """(G, H, W, C) -> the reflect-padded plane (edge replication where a
    pad is not smaller than the frame)."""
    h, w = x.shape[1:3]
    top, left = halo, halo
    bottom, right = _round_up(h, multiple) - h + halo, _round_up(w, multiple) - w + halo
    mode = "reflect" if max(top, bottom, left, right) < min(h, w) else "replicate"
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), mode=mode)
    return y.permute(0, 2, 3, 1)


def banded(net: Callable[[Tensor], Tensor], plane: Tensor, context: int, band_rows: int) -> Tensor:
    """net over the plane's rows in bands of `band_rows` (a multiple of the
    model's multiple), each run with `context` rows above and below."""
    ph = plane.shape[1]
    if band_rows >= ph:
        return net(plane)
    outs = []
    for a in range(0, ph, band_rows):
        b = min(a + band_rows, ph)
        lo, hi = max(0, a - context), min(ph, b + context)
        outs.append(net(plane[:, lo:hi].contiguous())[:, a - lo: b - lo])
    return torch.cat(outs, dim=1)


def decode(y: Tensor, albedo: Tensor):
    """(H, W, 6) log-demodulated direct + indirect -> raw (direct, indirect)."""
    d = torch.expm1(torch.clamp_min(y[..., 0:3], 0.0)) * (albedo + EPS)
    i = torch.expm1(torch.clamp_min(y[..., 3:6], 0.0)) * (albedo + EPS)
    return d, i


def recompose(out: Mapping[str, Tensor], pd: Mapping[str, Tensor]) -> Tensor:
    acc = None
    for g in LIGHT_GROUPS:
        d, i, c = _groups(g)
        t = pd[c] * (out[d] + out[i])
        acc = t if acc is None else acc + t
    return acc + pd["emission"] + pd["environment"]


@torch.no_grad()
def denoise(net: Callable[[Tensor], Tensor], pd: Mapping[str, Tensor], mode: str,
            halo: int, context: int, multiple: int, band_rows: int) -> Dict[str, Tensor]:
    """The denoised direct and indirect passes of every group and the
    recomposed 'combined' of one frame {pass: (H, W, C) fp32}."""
    x = encode(pd, mode)
    h, w = x.shape[1:3]
    plane = pad_plane(x, halo, multiple)
    del x
    y = banded(net, plane, context, band_rows)[:, halo: halo + h, halo: halo + w]
    out: Dict[str, Tensor] = {}
    for gi, g in enumerate(LIGHT_GROUPS):
        d, i, c = _groups(g)
        yg = y[0, ..., 6 * gi: 6 * gi + 6] if mode == "joint" else y[gi]
        out[d], out[i] = decode(yg, pd[c])
    out["combined"] = recompose(out, pd)
    return out
