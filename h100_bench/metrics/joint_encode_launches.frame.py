"""Launches a frame of the joint encode kernel, which writes the joint
frame's padded plane: the program's count `ops/fused_ingest.
joint_encode_launches` over the frames the run denoised. None where the
program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "launches/frame", "lower", "program_counter"
LAYER = "encode (ops/fused_ingest, csrc/fused_ingest.cu)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.per_frame_count(run, "deepdenoiser_tpu_torch.ops.fused_ingest",
                                 "joint_encode_launches")
