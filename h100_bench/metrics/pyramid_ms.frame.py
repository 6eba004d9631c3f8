"""Device ms a frame of the operations launched inside the program's
`pyramid` spans: the multi-scale wrapper's input pyramid, its 2x2 average
pools of the plane."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "multi-scale wrapper (models/multiscale)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "pyramid")
