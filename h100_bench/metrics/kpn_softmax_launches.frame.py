"""Launches a frame of the KPN head's norm-and-softmax kernel: the
program's count `ops/kpn_softmax.launches` (one a CUDA launch, a slot of a
network call) over the frames the run denoised. None where the program has
no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "launches/frame", "lower", "program_counter"
LAYER = "head (models/kpn)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.ops.kpn_softmax", "launches")
