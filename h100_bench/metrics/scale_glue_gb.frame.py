"""GB a frame written by the multi-scale wrapper's glue: the program's
count `models/multiscale.glue_bytes` (the input pyramid's pools and each
composition step's pool, difference, upsample and sum, from their shapes)
over the frames the run denoised, in 1e9 bytes. None where the program has
no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "GB/frame", "lower", "program_counter"
LAYER = "multi-scale wrapper (models/multiscale)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    n = spans.per_frame_count(run, "deepdenoiser_tpu_torch.models.multiscale", "glue_bytes")
    return None if n is None else n / 1e9
