"""The group encode (K2-K6 in one launch): every group's passes and the aux
read once and the (4, H, W, 14) batch written once, at 3.35 TB/s, over the
device time of the kernels named below."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "encode (ops/fused_ingest, csrc/fused_ingest.cu)"
MOVES = "frames_per_s"
PATTERNS = readers.GROUP_ENCODE


def read(run):
    if run.cell.traffic["driver"] != "frames" or counts.mode(run.model) != "group":
        return None
    h, w = readers.frame_hw(run)
    rows = [counts.count_group_encode(len(counts.LIGHT_GROUPS), h, w)]
    return readers.roofline_pct(counts.bound_s(rows) * run.attempted,
                                readers.device_ns(run, PATTERNS))
