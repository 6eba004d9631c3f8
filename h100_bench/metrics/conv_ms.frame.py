"""Device ms a frame of the convolution library's kernels, by name."""

from h100_bench import readers

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "backbone (models/unet, models/layers)"
MOVES = "frames_per_s"
PATTERNS = readers.CONV
EXCLUDE = readers.NOT_CONV


def read(run):
    if run.cell.traffic["driver"] != "frames" or not run.attempted:
        return None
    ns = readers.device_ns(run, PATTERNS, EXCLUDE)
    return None if ns is None else ns / 1e6 / run.attempted
