"""Launches a frame of the resize-convs' sub-pixel epilogue, the conv
epilogue kernel's instantiation that interleaves the four output phases of
each decoder UpSample: the program's count `ops/bias_act.
subpixel_launches` over the frames the run denoised. None where the program
has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "launches/frame", "lower", "program_counter"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.ops.bias_act",
                                 "subpixel_launches")
