"""The share of the traced slice in which no kernel, copy or fill ran on
the device, %."""


def read(run):
    if run.slice is None or not run.slice.device:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.seconds)
