"""Device ms a frame of the operations launched inside the program's `net`
span and no span within it: the reflect pad, the tile gather, the last
chunk's fill, the crop or stitch."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "plane and tiles (inference/tiled)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "net")
