"""Frames completed in the window over the window's seconds (host clock;
a frame is complete when the device has reached the event after its call)."""

UNIT, BETTER, SOURCE = "frames/s", "higher", "host_clock"


def read(run):
    if run.cell.traffic["driver"] != "frames" or run.window_s <= 0:
        return None
    return run.attempted / run.window_s
