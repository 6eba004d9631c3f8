"""Launches a frame of the conv epilogue kernel, the bias and activation
after each conv of the backbone and its linear head: the program's count
`ops/bias_act.launches` (one a CUDA launch) over the frames the run
denoised. None where the program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "launches/frame", "lower", "program_counter"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.ops.bias_act", "launches")
