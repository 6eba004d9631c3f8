"""GB a frame of logits read by the KPN head: the program's count
`models/kpn.logit_bytes` (each slot's logits, from their shapes at their
dtype) over the frames the run denoised, in 1e9 bytes. None where the
program has no such count."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "GB/frame", "lower", "program_counter"
LAYER = "head (models/kpn)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    n = spans.per_frame_count(run, "deepdenoiser_tpu_torch.models.kpn", "logit_bytes")
    return None if n is None else n / 1e9
