"""Frame planning and the canonical padded plane.

The port of the whole-frame part of deepdenoiser_tpu/inference/tiled.py:
the frame is reflect-padded by the halo into a "padded plane", the network
runs on that plane, and the result is cropped back. make_tiled_apply keeps
the JAX name and arguments; with batch_dims=1 a (G, H, W, C) stack of
frames becomes one padded batch and one network call (the group frame's
four light groups). Tiled execution (tile > 0, tile batches, feathered
stitching) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static plan for one frame geometry (same fields as the JAX one)."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    halo: int  # per-side halo hp
    rows: int
    cols: int

    @property
    def net_h(self) -> int:
        return self.tile_h + 2 * self.halo

    @property
    def net_w(self) -> int:
        return self.tile_w + 2 * self.halo

    @property
    def padded_hw(self) -> Tuple[int, int]:
        return self.rows * self.tile_h, self.cols * self.tile_w


def plan_grid(height: int, width: int, tile: int, halo: int, multiple: int) -> TileGrid:
    """Aligned plan: halo and tile sides rounded up to `multiple`. tile == 0
    is whole-frame mode, one tile of the frame's rounded-up size."""
    halo = _round_up(halo, multiple)
    if tile == 0:
        return TileGrid(height, width, _round_up(height, multiple),
                        _round_up(width, multiple), halo, 1, 1)
    tile = _round_up(max(tile, multiple), multiple)
    return TileGrid(height, width, tile, tile, halo,
                    -(-height // tile), -(-width // tile))


def pad_plane(frame: Tensor, grid: TileGrid) -> Tensor:
    """(H, W, C) or (G, H, W, C) -> the padded plane(s): reflect-pad halo on
    top/left, halo + grid rounding on bottom/right; edge replication when a
    pad is not smaller than the frame (reflect needs pad < dim)."""
    h, w = frame.shape[-3:-1]
    if (h, w) != (grid.height, grid.width):
        raise ValueError(f"frame {tuple(frame.shape)} does not match {grid}")
    ph, pw = grid.padded_hw
    hp = grid.halo
    top, bottom, left, right = hp, ph - h + hp, hp, pw - w + hp
    mode = "reflect" if max(top, bottom, left, right) < min(h, w) else "replicate"
    # F.pad pads the last dims of an (N, C, H, W) tensor
    batched = frame.dim() == 4
    x = frame.permute(0, 3, 1, 2) if batched else frame.permute(2, 0, 1)[None]
    x = F.pad(x, (left, right, top, bottom), mode=mode).permute(0, 2, 3, 1).contiguous()
    return x if batched else x[0]


def whole_frame_reference(apply_fn: Callable[[Tensor], Tensor], frame: Tensor,
                          grid: TileGrid) -> Tensor:
    """Run the network over the full padded plane in one call and crop the
    frame region."""
    return make_tiled_apply(apply_fn, grid, None)(frame)


def make_tiled_apply(apply_fn: Callable[[Tensor], Tensor], grid: TileGrid,
                     out_channels: Optional[int] = None, tile_batch: int = 0,
                     batch_dims: int = 0, feather: bool = False,
                     ) -> Callable[[Tensor], Tensor]:
    """f: (H, W, C) -> (H, W, out_channels), or with batch_dims=1
    (G, H, W, C) -> (G, H, W, out_channels): all G frames padded into one
    batch, one network call, the frame region cropped. Whole-frame grids
    only (plan_grid with tile=0); `out_channels`, when given, is checked
    against what the network returns."""
    if grid.rows * grid.cols != 1 or tile_batch or feather:
        raise NotImplementedError("tiled inference is not ported yet (tile=0 only)")
    if batch_dims not in (0, 1):
        raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims}")
    hp = grid.halo

    def f(frames: Tensor) -> Tensor:
        if frames.dim() != 3 + batch_dims:
            raise ValueError(f"expected {3 + batch_dims} dims, got {tuple(frames.shape)}")
        planes = pad_plane(frames, grid)
        y = apply_fn(planes if batch_dims else planes[None])
        if out_channels is not None and y.shape[-1] != out_channels:
            raise ValueError(f"network returned {y.shape[-1]} channels, want {out_channels}")
        y = y[:, hp : hp + grid.height, hp : hp + grid.width]
        return y if batch_dims else y[0]

    return f
