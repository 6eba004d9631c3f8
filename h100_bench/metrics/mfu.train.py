"""The train step's share of the card's bf16 peak: 3 x the forward's conv
FLOPs at batch x crop², times the steps completed, over the window (host
clock), over 989 TFLOP/s: train_samples_per_s scaled by the counted FLOPs."""

from h100_bench import counts, readers

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "train step (training/train)"
MOVES = "train_samples_per_s"


def read(run):
    t = run.cell.traffic
    if t["driver"] != "train":
        return None
    model = {**run.model, "compute_dtype": run.cell.config["model"]["compute_dtype"]}
    conv = sum(r.flops for r in counts.count_network(model, t["batch"], t["crop"], t["crop"],
                                                     readers.arch(run))
               if r.kind == "conv")
    return 100.0 * 3 * conv * run.attempted / run.window_s / counts.PEAK_FLOPS["bfloat16"]
