"""Device ms a frame of the operations launched inside the program's `head`
span and no span within it: the signal gather, the logits' cast, RMS norm
and softmax, the concatenation of the slots; K1 (its `k1` spans) is not
counted."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "head (models/kpn)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "head")
