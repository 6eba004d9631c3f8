"""95th percentile of every frame's latency in the window: CUDA events
recorded on the stream before and after the call (the device's clock)."""

from h100_bench import readers

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return readers.p95(run.latencies_ms)
