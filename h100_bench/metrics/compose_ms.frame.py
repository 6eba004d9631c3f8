"""Device ms a frame of the operations launched inside the program's
`compose` spans: the multi-scale wrapper's coarse-to-fine composition
steps, out_s = pred_s + up(out_(s+1) - down(pred_s))."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "multi-scale wrapper (models/multiscale)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "compose")
