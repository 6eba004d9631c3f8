"""Set-up: process start to the window's start (imports, the kernel build
on a checkout's first run, weights, inputs, warm-up), host clock."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
