"""Backbone runs a frame in the multi-scale wrapper: the program's count
`models/multiscale.backbone_calls` (one a scale of each network call) over
the frames the run denoised. None where the program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "calls/frame", "lower", "program_counter"
LAYER = "multi-scale wrapper (models/multiscale)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.models.multiscale", "backbone_calls")
