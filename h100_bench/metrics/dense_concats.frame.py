"""Multi-input channel concatenations a frame in the FC-DenseNet backbone:
the program's count `models/tiramisu.concats` (a dense layer's input, a
block's new maps, the joins [x, block] and [up, skip]) over the frames the
run denoised. None where the program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "calls/frame", "lower", "program_counter"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.models.tiramisu", "concats")
