"""Device ms a frame of the operations launched inside the program's
`decode` span: decode, the passes carried through, the recompose."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "decode (transforms)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "decode")
