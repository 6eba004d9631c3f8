"""The device's peak allocated memory over the window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), less the
harness's inputs and the outputs it keeps for the check, GiB."""

UNIT, BETTER, SOURCE = "GiB", "lower", "device_trace"


def read(run):
    if run.peak_bytes <= 0:
        return None
    return (run.peak_bytes - run.input_bytes - run.held_bytes) / 2 ** 30
