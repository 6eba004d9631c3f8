"""Device ms a frame of the operations launched inside the program's
`dense` spans: the FC-DenseNet's dense blocks with their joins [x, block],
convolutions and concatenations included."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "dense")
