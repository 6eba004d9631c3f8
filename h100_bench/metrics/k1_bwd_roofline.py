"""K1's weight gradient: the bytes it needs (signal and output gradient
read once, d_w written once, every slot of every step), at 3.35 TB/s, over
the device time of the kernels named below."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernel K1 backward (csrc/kpn_apply_bwd.cu)"
MOVES = "train_samples_per_s"
PATTERNS = readers.K1_BWD_WEIGHTS


def read(run):
    t, m = run.cell.traffic, run.model
    if t["driver"] != "train" or not m["kernel_prediction"]:
        return None
    rows = [counts.count_kpn_apply_bwd_weights(t["batch"], t["crop"], t["crop"],
                                               m["kpn_size"])] * m["kpn_slots"]
    return readers.roofline_pct(counts.bound_s(rows) * run.attempted,
                                readers.device_ns(run, PATTERNS))
