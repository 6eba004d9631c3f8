"""Device ms a frame of the operations launched inside the program's
`encode` span and no span within it: the joint encode, the group encode
(K2-K6 in one launch, or the stacked plain encode), the rgb encode."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "encode (ops/fused_ingest, csrc/fused_ingest.cu)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.layer_ms(run, "encode")
