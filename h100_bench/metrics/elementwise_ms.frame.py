"""Device ms a frame of every operation that is neither a convolution
kernel, nor K1, nor the group encode: bias, leaky-ReLU, upsample, concat,
RMS-norm, softmax, encode, decode, copies."""

from h100_bench import readers

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "backbone and head (models/layers, models/kpn)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames" or not run.attempted or run.kernels is None:
        return None
    total = sum(d for _, _, d in run.kernels)
    other = (readers.device_ns(run, readers.CONV, readers.NOT_CONV)
             + readers.device_ns(run, readers.K1) + readers.device_ns(run, readers.GROUP_ENCODE))
    return (total - other) / 1e6 / run.attempted
