"""Share of the traced window in which no kernel, copy or memset ran on
the card (frame cells)."""

from h100_bench import readers

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    if run.cell.traffic["driver"] != "frames":
        return None
    return readers.idle_pct(run)
