"""Tiled full-frame inference with certified halos, and the canonical
padded plane.

The port of deepdenoiser_tpu/inference/tiled.py:

  * a static tile grid — rows x cols tiles of core size t, each padded by
    the halo hp on every side to the network size T = t + 2*hp;
  * the tiles are taken from the padded plane as one strided view
    (`Tensor.unfold`, no loop over tiles) and run through the network as a
    batch, in chunks of `tile_batch` where memory has to be bounded;
  * the core regions are cropped and reassembled by reshape and permute.

Frame borders: the frame is reflect-padded by the halo into a "padded
plane" (pad_plane); the network conceptually runs on that plane and the
result is cropped back. Tiled and untiled runs then see the same data in
every output pixel's receptive field, and they agree exactly (not
approximately) because
  1. hp >= the model's certified one-sided receptive-field bound
     (models.factory.halo), so a core pixel's receptive field never reaches
     a tile edge;
  2. t % m == 0 and hp % m == 0 (m = the model's downsampling multiple), so
     every tile origin is congruent 0 mod m and the stride-2 grids inside a
     tile coincide with the whole frame's.
"Exactly" is up to the convolution library choosing another algorithm, and
so another summation order, for another tensor shape.

Whole-frame mode (tile=0) is the one-tile grid: with batch_dims=1 a
(G, H, W, C) stack of frames becomes one padded batch and one network call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepdenoiser_tpu_torch import tracing

Tensor = torch.Tensor

# Network calls made by the tiled applies since the last reset: one a
# chunk of tiles, or one for a whole plane or batch of planes (a plain
# count; `net` adds one where it calls the network and nowhere else).
net_calls = 0


def reset_net_calls() -> None:
    global net_calls
    net_calls = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tiling plan for one frame geometry (same fields as the JAX
    one). Tiles are rectangular (tile_h x tile_w cores); the square-tile
    plan sets both equal, and whole-frame mode (tile=0) is one frame-sized
    tile."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    halo: int  # per-side halo hp
    rows: int
    cols: int

    @property
    def tile(self) -> int:
        assert self.tile_h == self.tile_w, "square-tile accessor on rect grid"
        return self.tile_h

    @property
    def net_h(self) -> int:
        return self.tile_h + 2 * self.halo

    @property
    def net_w(self) -> int:
        return self.tile_w + 2 * self.halo

    @property
    def net_size(self) -> int:
        assert self.tile_h == self.tile_w
        return self.tile_h + 2 * self.halo

    @property
    def n_tiles(self) -> int:
        return self.rows * self.cols

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


def plane_pads(grid: TileGrid) -> Tuple[int, int, int, int, str]:
    """(top, bottom, left, right, mode) of the padded plane: the halo on
    top/left, halo + grid rounding on bottom/right; mode "reflect"
    (PyTorch's: the edge pixel not repeated), or "replicate" when a pad is
    not smaller than the frame (reflect needs pad < dim). The one rule of
    the plane's border, for pad_plane and the joint encode kernel
    (ops/fused_ingest.encode_joint_plane)."""
    h, w = grid.height, grid.width
    ph, pw = grid.padded_hw
    hp = grid.halo
    top, bottom, left, right = hp, ph - h + hp, hp, pw - w + hp
    mode = "reflect" if max(top, bottom, left, right) < min(h, w) else "replicate"
    return top, bottom, left, right, mode


def plane_hw(grid: TileGrid) -> Tuple[int, int]:
    """(height, width) of the padded plane."""
    ph, pw = grid.padded_hw
    return ph + 2 * grid.halo, pw + 2 * grid.halo


def pad_plane(frame: Tensor, grid: TileGrid) -> Tensor:
    """(H, W, C) or (G, H, W, C) -> the padded plane(s), bordered as
    plane_pads says."""
    h, w = frame.shape[-3:-1]
    if (h, w) != (grid.height, grid.width):
        raise ValueError(f"frame {tuple(frame.shape)} does not match {grid}")
    top, bottom, left, right, mode = plane_pads(grid)
    # F.pad pads the last dims of an (N, C, H, W) tensor
    batched = frame.dim() == 4
    x = frame.permute(0, 3, 1, 2) if batched else frame.permute(2, 0, 1)[None]
    x = F.pad(x, (left, right, top, bottom), mode=mode).permute(0, 2, 3, 1).contiguous()
    return x if batched else x[0]


def whole_frame_reference(apply_fn: Callable[[Tensor], Tensor], frame: Tensor,
                          grid: TileGrid) -> Tensor:
    """Untiled execution of the canonical semantics: run the network over
    the full padded plane in one call and crop the frame region. What the
    tiled path must match."""
    hp = grid.halo
    y = apply_fn(pad_plane(frame, grid)[None])[0]
    return y[hp : hp + grid.height, hp : hp + grid.width]


def _tile_view(padded: Tensor, grid: TileGrid) -> Tensor:
    """(..., PH, PW, C) padded plane(s) -> (..., rows, cols, C, Th, Tw): the
    overlapping network tiles as a strided view of the plane, no copy."""
    return padded.unfold(-3, grid.net_h, grid.tile_h).unfold(-3, grid.net_w, grid.tile_w)


def extract_tiles(frame: Tensor, grid: TileGrid) -> Tensor:
    """frame (H, W, C) -> tiles (rows*cols, Th, Tw, C) from the padded
    plane, row-major over the grid."""
    return plane_tiles(pad_plane(frame, grid), grid)


def plane_tiles(padded: Tensor, grid: TileGrid) -> Tensor:
    """extract_tiles from the padded plane (PH + 2hp, PW + 2hp, C)."""
    if grid.n_tiles == 1:
        return padded[None]
    v = _tile_view(padded, grid)  # (rows, cols, C, Th, Tw)
    return v.permute(0, 1, 3, 4, 2).reshape(grid.n_tiles, grid.net_h, grid.net_w, -1)


def _assemble(cores: Tensor, grid: TileGrid) -> Tensor:
    """(..., rows*cols, th, tw, C) core crops -> (..., H, W, C)."""
    th, tw = grid.tile_h, grid.tile_w
    lead, c = cores.shape[:-4], cores.shape[-1]
    full = cores.reshape(*lead, grid.rows, grid.cols, th, tw, c).transpose(-4, -3)
    full = full.reshape(*lead, grid.rows * th, grid.cols * tw, c)
    return full[..., : grid.height, : grid.width, :]


def stitch_tiles(tiles_out: Tensor, grid: TileGrid) -> Tensor:
    """(rows*cols, Th, Tw, C) network outputs -> (H, W, C): the core of
    every tile, reassembled. Leading batch dimensions are kept."""
    hp, th, tw = grid.halo, grid.tile_h, grid.tile_w
    return _assemble(tiles_out[..., hp : hp + th, hp : hp + tw, :], grid)


def make_tiled_apply(apply_fn: Callable[[Tensor], Tensor], grid: TileGrid,
                     out_channels: Optional[int] = None, tile_batch: int = 0,
                     batch_dims: int = 0, feather: bool = False,
                     ) -> Callable[[Tensor], Tensor]:
    """Build `f(frame) -> denoised frame` running apply_fn over the tile grid,
    and `f.on_plane(plane)`, the same run on the frame's padded plane (what
    pad_plane gives) for a caller that has made it already.

    apply_fn: (N, Th, Tw, Cin) -> (N, Th, Tw, Cout), the network.
    out_channels, when given, is checked against what the network returns.
    tile_batch: tiles per network call (0 = all tiles in one batch); the
      last chunk is zero-padded (batch_dims=1) or wraps around to the first
      tiles (batch_dims=0), so every call has the same shape.
    batch_dims=1 makes f accept (G, H, W, C) stacks (all light groups at
      once) and run them as one tile batch.
    feather: cosine overlap blending instead of exact center-crop
      stitching (InferenceConfig.stitch='feather'). Not available in the
      memory-bounded lazy mode.
    """
    if batch_dims not in (0, 1):
        raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims}")
    lazy = batch_dims == 0 and tile_batch and tile_batch < grid.n_tiles
    if feather and lazy:
        raise ValueError("feathered stitching is unsupported in the "
                         "memory-bounded lazy-chunk mode (tile_batch with "
                         "batch_dims=0); use exact stitching there")
    stitch = stitch_tiles_feathered if feather else stitch_tiles
    hp = grid.halo

    def net(tiles: Tensor) -> Tensor:
        global net_calls
        with tracing.span("chunk"):
            y = apply_fn(tiles)
        net_calls += 1
        if out_channels is not None and y.shape[-1] != out_channels:
            raise ValueError(f"network returned {y.shape[-1]} channels, want {out_channels}")
        return y

    def run_tiles(tiles: Tensor) -> Tensor:
        n = tiles.shape[0]
        if not (tile_batch and tile_batch < n):
            return net(tiles)
        outs = []
        for start in range(0, n, tile_batch):
            chunk = tiles[start : start + tile_batch]
            short = tile_batch - chunk.shape[0]
            if short:
                chunk = torch.cat((chunk, chunk.new_zeros((short, *chunk.shape[1:]))), 0)
            outs.append(net(chunk))
        return torch.cat(outs, 0)[:n]

    plane_shape = plane_hw(grid)

    def entry(run_plane: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
        """f(frame) = run_plane(pad_plane(frame)); f.on_plane(plane) runs
        on a plane that is already padded (the joint encode kernel writes
        one)."""

        def f(frames: Tensor) -> Tensor:
            if frames.dim() != 3 + batch_dims:
                raise ValueError(f"expected {3 + batch_dims} dims, got {tuple(frames.shape)}")
            return run_plane(pad_plane(frames, grid))

        def on_plane(planes: Tensor) -> Tensor:
            if planes.dim() != 3 + batch_dims or tuple(planes.shape[-3:-1]) != plane_shape:
                raise ValueError(f"plane {tuple(planes.shape)} is not the {plane_shape} "
                                 f"plane of {grid}")
            return run_plane(planes)

        f.on_plane = on_plane
        return f

    if lazy:
        # Memory-bounded mode: only one chunk of network tiles exists at a
        # time, gathered from the strided tile view of the padded plane, and
        # each chunk's output is core-cropped at once. Peak live memory is
        # the plane + one chunk's activations + the core outputs: the path
        # for frames whose full tile set does not fit (4K). The JAX
        # package flattens the plane to (H, W*C) first, against the TPU's
        # 128-lane padding of a narrow minor dimension; a CUDA tensor has no
        # such padding, so the NHWC plane is sliced as it is.
        def lazy_plane(plane: Tensor) -> Tensor:
            # (rows, cols, Th, Tw, C), a view of the plane
            view = _tile_view(plane, grid).permute(0, 1, 3, 4, 2)
            n = grid.n_tiles
            nchunks = -(-n // tile_batch)
            idx = torch.arange(nchunks * tile_batch, device=plane.device) % n
            cores = []
            for ch in idx.reshape(nchunks, tile_batch):
                tiles = view[ch // grid.cols, ch % grid.cols].contiguous()
                out = net(tiles)
                cores.append(out[:, hp : hp + grid.tile_h, hp : hp + grid.tile_w, :])
            return _assemble(torch.cat(cores, 0)[:n], grid)

        return entry(lazy_plane)

    if batch_dims == 0:
        return entry(lambda plane: stitch(run_tiles(plane_tiles(plane, grid)), grid))

    def batched_plane(planes: Tensor) -> Tensor:
        g = planes.shape[0]
        if grid.n_tiles == 1:
            tiles = planes
        else:
            v = _tile_view(planes, grid)  # (G, rows, cols, C, Th, Tw)
            tiles = v.permute(0, 1, 2, 4, 5, 3).reshape(
                g * grid.n_tiles, grid.net_h, grid.net_w, -1)
        outs = run_tiles(tiles)
        outs = outs.reshape(g, grid.n_tiles, *outs.shape[1:])
        if feather:
            return torch.stack([stitch_tiles_feathered(o, grid) for o in outs], 0)
        return stitch_tiles(outs, grid)

    return entry(batched_plane)


# ---------------------------------------------------------------------------
# Feathered blending (sub-certified halos; quality/throughput trade-off)
# ---------------------------------------------------------------------------


def _feather_window(t: int, hp: int) -> np.ndarray:
    """Partition-of-unity 1-D weight over a T = t + 2hp tile: cosine ramps in
    the overlap, flat core. Adjacent tiles' windows sum to exactly 1."""
    T = t + 2 * hp
    w = np.ones(T, dtype=np.float32)
    if hp > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(2 * hp) + 0.5) / (2 * hp))
        w[: 2 * hp] = ramp
        w[-2 * hp :] = ramp[::-1]
    return w


def stitch_tiles_feathered(tiles_out: Tensor, grid: TileGrid) -> Tensor:
    """Overlap-blend stitching: cosine partition of unity over the 2*halo
    overlap regions. For halos below the certified bound (faster tiles,
    approximate seams); with certified halos center-crop stitching is exact
    and cheaper.

    One `F.fold` sums the weighted tiles into the plane (and a second the
    weights), instead of a loop of slice updates over the tiles."""
    hp, th, tw = grid.halo, grid.tile_h, grid.tile_w
    n, nh, nw, c = tiles_out.shape
    w2 = torch.from_numpy(np.outer(_feather_window(th, hp), _feather_window(tw, hp))).to(
        device=tiles_out.device, dtype=tiles_out.dtype)
    ph, pw = grid.rows * th + 2 * hp, grid.cols * tw + 2 * hp

    def overlap_add(tiles_cl: Tensor) -> Tensor:
        """(n, C', Th, Tw) -> (C', ph, pw): every tile added at its origin."""
        cols = tiles_cl.reshape(n, -1).t()[None]  # (1, C'*Th*Tw, n)
        return F.fold(cols, (ph, pw), kernel_size=(nh, nw), stride=(th, tw))[0]

    acc = overlap_add((tiles_out * w2[None, :, :, None]).permute(0, 3, 1, 2))
    wacc = overlap_add(w2.expand(n, 1, nh, nw))
    out = (acc / wacc.clamp_min(1e-8)).permute(1, 2, 0)
    return out[hp : hp + grid.height, hp : hp + grid.width, :]
