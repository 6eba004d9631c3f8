"""Band-parallel frames with halo exchange, over a 'spatial' mesh axis.

The port of deepdenoiser_tpu/parallel/halo.py. Band i of n owns rows
[i*b, (i+1)*b) of the padded plane's core. Its network input is the band
with hp rows above and below: the neighbours' band[-hp:] and band[:hp],
copied from the neighbour's device (the JAX package's ppermute), or, at
the frame's top and bottom, the plane's reflect strips. Band origins are
aligned to the model's downsampling multiple and hp covers the certified
receptive field, so the result equals the whole frame run on the same
plane (the argument of inference/tiled.py).

One process drives every device. The frame is padded on the device it
lies on; each band's input is assembled on mesh device i (the band's rows,
then the two strips, each one copy, over peer access when the cards
differ) and run through a model replica there, one replica per distinct
device. All bands are launched before any result is read, so bands on
distinct cards overlap; bands that share a card run one after another. The
cropped outputs are gathered on the first device of the axis.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import torch

from deepdenoiser_tpu_torch.inference import tiled
from deepdenoiser_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_bands(height: int, width: int, n_shards: int, halo: int, multiple: int
               ) -> Tuple[tiled.TileGrid, int]:
    """A 1 x 1 grid describing the padded plane, and the band height b.

    The plane's core is padded to n_shards * b rows (b % multiple == 0), so
    every band origin is grid-aligned."""
    hp = _round_up(halo, multiple)
    b = _round_up(-(-height // n_shards), multiple)
    if b < hp:
        # the exchange reaches the immediate neighbour only: a halo taller
        # than a band would need rows from two bands away
        raise ValueError(
            f"band height {b} < halo {hp}: frame of {height} rows is too "
            f"short for {n_shards} spatial shards of this model (needs "
            f"height >= {n_shards * hp}); use fewer shards or tiles")
    grid = tiled.TileGrid(height, width, n_shards * b, _round_up(width, multiple), hp, 1, 1)
    return grid, b


def replicas(apply_fn: Callable[[Tensor], Tensor], devices) -> Dict[torch.device, Callable]:
    """{device: apply_fn there}. A Module is copied once to each distinct
    device it is not on yet (its own device keeps the original); any other
    callable must follow its input's device and is used as it is."""
    out: Dict[torch.device, Callable] = {}
    home = None
    if isinstance(apply_fn, torch.nn.Module):
        home = next(apply_fn.parameters()).device
    for d in devices:
        if d in out:
            continue
        if home is None or d == home:
            out[d] = apply_fn
        else:
            out[d] = copy.deepcopy(apply_fn).to(d)
    return out


def make_spatial_apply_batched(apply_fn: Callable[[Tensor], Tensor], mesh: Mesh, height: int,
                               width: int, halo: int, multiple: int, axis: str = "spatial"
                               ) -> Callable[[Tensor], Tensor]:
    """f(frames (G, H, W, C)) -> (G, H, W, Cout), rows in bands over
    `axis`; the G frames (the light groups) ride along in every band's
    network call. apply_fn: (G, Hb, Wp, C) -> (G, Hb, Wp, Cout)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    grid, b = plan_bands(height, width, n, halo, multiple)
    hp = grid.halo
    nets = replicas(apply_fn, devs)

    def f(frames: Tensor) -> Tensor:
        plane = tiled.pad_plane(frames, grid)  # (G, n*b + 2hp, Wp + 2hp, C)
        shape = (plane.shape[0], b + 2 * hp, *plane.shape[2:])
        xs = []
        for i, d in enumerate(devs):  # each band's rows onto its device
            x = torch.empty(shape, dtype=plane.dtype, device=d)
            x[:, hp : hp + b].copy_(plane[:, hp + i * b : hp + (i + 1) * b])
            xs.append(x)
        for i, x in enumerate(xs):  # the exchange: neighbours' edge rows
            x[:, :hp].copy_(plane[:, :hp] if i == 0 else xs[i - 1][:, b : b + hp])
            x[:, hp + b :].copy_(plane[:, hp + n * b :] if i == n - 1 else xs[i + 1][:, hp : 2 * hp])
        ys = [nets[d](x)[:, hp : hp + b] for d, x in zip(devs, xs)]
        out = torch.cat([y.to(devs[0]) for y in ys], dim=1)  # (G, n*b, Wp + 2hp, Cout)
        return out[:, :height, hp : hp + width]

    return f


def make_spatial_apply(apply_fn: Callable[[Tensor], Tensor], mesh: Mesh, height: int,
                       width: int, halo: int, multiple: int, axis: str = "spatial"
                       ) -> Callable[[Tensor], Tensor]:
    """f(frame (H, W, C)) -> (H, W, Cout) in bands over `axis`; apply_fn:
    (1, Hb, Wp, C) -> (1, Hb, Wp, Cout)."""
    batched = make_spatial_apply_batched(apply_fn, mesh, height, width, halo, multiple, axis)
    return lambda frame: batched(frame[None])[0]
