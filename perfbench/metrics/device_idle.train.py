"""device_idle.train: the share of the traced step's wall time in which no
operation ran on the device (outside the union of their intervals), in %."""


def read(ctx, outcome):
    r = outcome.reading
    return 100.0 * (1.0 - r.busy_s / r.window_s)
