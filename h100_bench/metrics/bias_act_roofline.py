"""The conv epilogue kernel (bias and activation): the bytes of the bias
rows that counts.py gives the frame's network (each conv's output read
once with its bias, written once, over the tiles or planes a frame's
network runs on), at 3.35 TB/s, over the device time of the kernel named
below. None where the trace holds no such kernel."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"
PATTERNS = ("bias_act_kernel",)


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    rows = [r for r in counts.count_network(run.model, *readers.net_batch(run), readers.arch(run))
            if r.kind == "bias"]
    return readers.roofline_pct(counts.bound_s(rows) * run.attempted,
                                readers.device_ns(run, PATTERNS))
