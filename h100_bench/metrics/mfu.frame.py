"""The frame's share of the card's bf16 peak: the FLOPs one frame needs,
counted from shapes over the whole padded plane at the cell's size (a tiled
frame's halo recompute is not counted), times the frames completed, over
the window (host clock), over 989 TFLOP/s. So it is frames_per_s scaled by
the counted FLOPs: it bounds the kernels' rooflines from above."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole frame (inference/pipeline)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    flops = readers.whole_frame_flops(run) * run.attempted
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS["bfloat16"]
