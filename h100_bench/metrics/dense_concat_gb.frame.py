"""GB a frame written by the FC-DenseNet backbone's multi-input channel
concatenations: the program's count `models/tiramisu.concat_bytes` (each
concatenation's output, from its shapes) over the frames the run denoised,
in 1e9 bytes. None where the program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "GB/frame", "lower", "program_counter"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    n = spans.per_frame_count(run, "deepdenoiser_tpu_torch.models.tiramisu", "concat_bytes")
    return None if n is None else n / 1e9
