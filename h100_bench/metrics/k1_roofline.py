"""K1, the KPN filter apply: the bytes its work needs (every slot's signal
and weights read once, its output written once, over the tiles or planes a
frame's network runs on), at 3.35 TB/s, over the device time of the
kernels named below. Counted as work, not launches: a launch that fuses
slots reads the same count."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernel K1 (ops/kpn_apply, csrc/kpn_apply.cu)"
MOVES = "frames_per_s"
PATTERNS = readers.K1


def read(run):
    m = run.model
    if run.cell.traffic["driver"] != "frames" or not m["kernel_prediction"]:
        return None
    n, h, w = readers.net_batch(run)
    rows = [counts.count_kpn_apply(n, h, w, m["kpn_size"])] * m["kpn_slots"]
    return readers.roofline_pct(counts.bound_s(rows) * run.attempted,
                                readers.device_ns(run, PATTERNS))
