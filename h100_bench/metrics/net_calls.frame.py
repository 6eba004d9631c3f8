"""Network calls a frame: the program's count `inference/tiled.net_calls`
(one a chunk of tiles, or one for a whole plane or batch of planes) over
the frames the run denoised."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "calls/frame", "lower", "program_counter"
LAYER = "plane and tiles (inference/tiled)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.inference.tiled", "net_calls")
