"""KS, the KPN head's norm-and-softmax kernel: the bytes its work needs, from
shapes, at 3.35 TB/s, over the device time of the kernels named below.
Each slot's logits are read once at the network's compute dtype (the
KPCN's trunk emits bf16 logits, which the kernel reads in place) and its
fp32 weights written once, over the tiles or planes a frame's network runs
on. None where the trace holds no such kernel."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "head (models/kpn)"
MOVES = "frames_per_s"
PATTERNS = ("kpn_softmax_kernel",)


def frame_bytes(run) -> int:
    """A frame's bytes: every slot's logits read, its weights written."""
    m = run.model
    n, h, w = readers.net_batch(run)
    per_tap = counts._BYTES[run.info["infer"]["compute_dtype"]] + 4
    return m["kpn_slots"] * n * h * w * m["kpn_size"] ** 2 * per_tap


def read(run):
    if run.cell.traffic["driver"] != "frames" or not run.model["kernel_prediction"]:
        return None
    return readers.roofline_pct(frame_bytes(run) / counts.PEAK_HBM_BPS * run.attempted,
                                readers.device_ns(run, PATTERNS))
