"""Pixels the network computes a frame over the frame's pixels: the
program's tile grid (tiles x net size, the last chunk filled to
tile_batch) over H x W."""

UNIT, BETTER, SOURCE = "ratio", "lower", "program_counter"
LAYER = "plane and tiles (inference/tiled)"
MOVES = "frames_per_s"


def read(run):
    grid = run.info.get("grid")
    if grid is None:
        return None
    n = grid.n_tiles
    tb = run.info["infer"]["tile_batch"]
    if n > 1 and tb and tb < n:
        n = -(-n // tb) * tb
    return n * grid.net_h * grid.net_w / (grid.height * grid.width)
