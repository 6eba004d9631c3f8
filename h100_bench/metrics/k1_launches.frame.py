"""K1 launches a frame: the program's count `ops/kpn_apply.launches` (one
a CUDA launch of the filter apply) over the frames the run denoised."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "launches/frame", "lower", "program_counter"
LAYER = "kernel K1 (ops/kpn_apply, csrc/kpn_apply.cu)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.ops.kpn_apply", "launches")
