"""Host ms a frame inside the program's `frame` spans: the denoiser call
returns before the device has finished its work, so this is the time the
host takes to dispatch a frame."""

from h100_bench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "host dispatch (inference/pipeline)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return spans.dispatch_ms(run)
