"""The joint encode into the padded plane: every group's direct, indirect
and color passes and the aux passes of the frame read once, and the fp32
plane the network runs on, (ph + 2 halo) x (pw + 2 halo) x in_channels of
the cell's grid, written once, at 3.35 TB/s, over the device time of the
kernel named below. None where the trace holds no such kernel."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "encode (ops/fused_ingest, csrc/fused_ingest.cu)"
MOVES = "frames_per_s"
PATTERNS = ("joint_encode_kernel",)


def read(run):
    if run.cell.traffic["driver"] != "frames" or counts.mode(run.model) != "joint":
        return None
    h, w = readers.frame_hw(run)
    grid = counts.plan(run.model, run.info["infer"], h, w, readers.certified_halo(run))
    ph, pw = grid.padded_hw
    c_src = 9 * len(counts.LIGHT_GROUPS) + sum(counts.AUX_CHANNELS.values())
    c_in = run.model["in_channels"]
    row = counts.Row("joint encode plane", "encode", "encode", counts.F32, h * w * c_src,
                     h * w * c_src * 4, (ph + 2 * grid.halo) * (pw + 2 * grid.halo) * c_in * 4)
    return readers.roofline_pct(counts.bound_s([row]) * run.attempted,
                                readers.device_ns(run, PATTERNS))
