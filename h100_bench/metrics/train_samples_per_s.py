"""Samples the window's steps trained (batch x steps) over the window's
seconds, the window closed by a synchronize (host clock)."""

UNIT, BETTER, SOURCE = "samples/s", "higher", "host_clock"


def read(run):
    if run.cell.traffic["driver"] != "train" or run.window_s <= 0:
        return None
    return run.cell.traffic["batch"] * run.attempted / run.window_s
