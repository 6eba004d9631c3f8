"""Device ms a frame of the operations launched inside the program's
`backbone` span: the network under the head, convolutions included
(conv_ms.frame is their part), with its bias, activations, resampling
and concatenations."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "backbone")
