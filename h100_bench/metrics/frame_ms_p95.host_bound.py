"""frame_ms_p95 read per layer, in the cells where the host sets a frame's
pace: the 95th percentile of every frame's latency in the window, CUDA
events recorded on the stream before and after the call (the device's
clock). Where the host's dispatch nears the device's time, the device
waits on the host inside each call, and the card's host slows for seconds
at a time under other load; the tail then swings from run to run more
than any bound that the other cells' tails allow."""

from h100_bench import readers

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "whole frame (inference/pipeline)"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return readers.p95(run.latencies_ms)
