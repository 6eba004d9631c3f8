"""Frame planning and the canonical padded plane.

The port of the whole-frame part of deepdenoiser_tpu/inference/tiled.py:
the frame is reflect-padded by the halo into a "padded plane", the network
runs on that plane, and the result is cropped back. Tiled execution
(tile > 0, tile batches, feathered stitching) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

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
    """(H, W, C) -> the padded plane: reflect-pad halo on top/left, halo +
    grid rounding on bottom/right; edge replication when a pad is not
    smaller than the frame (reflect needs pad < dim)."""
    h, w, _ = frame.shape
    if (h, w) != (grid.height, grid.width):
        raise ValueError(f"frame {tuple(frame.shape)} does not match {grid}")
    ph, pw = grid.padded_hw
    hp = grid.halo
    top, bottom, left, right = hp, ph - h + hp, hp, pw - w + hp
    mode = "reflect" if max(top, bottom, left, right) < min(h, w) else "replicate"
    # F.pad pads the last dims of an (N, C, H, W) tensor
    x = frame.permute(2, 0, 1)[None]
    return F.pad(x, (left, right, top, bottom), mode=mode)[0].permute(1, 2, 0).contiguous()


def whole_frame_reference(apply_fn: Callable[[Tensor], Tensor], frame: Tensor,
                          grid: TileGrid) -> Tensor:
    """Run the network over the full padded plane in one call and crop the
    frame region."""
    hp = grid.halo
    y = apply_fn(pad_plane(frame, grid)[None])[0]
    return y[hp : hp + grid.height, hp : hp + grid.width]
